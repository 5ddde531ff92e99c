"""repro_torch.launch — the port's entry points for the model stack:
`train` and `serve` (command-line launchers), `dryrun` (every arch x
input shape on a fake 256-rank production mesh, on meta tensors), and
its supporting tools `specs` (meta-device inputs and states),
`comm_stats` (collectives and op counts recorded as a step runs; the
counterpart of the reference's ``hlo_stats``) and `analytic`."""
