"""repro_torch.configs — the port's copy of the reference's ten model
architectures as `ArchConfig` dataclasses (one data module each), the
`registry.get_arch` / `ARCH_IDS` lookup and the (arch x input-shape)
applicability matrix.  `base.py` defines the config schema and the
canonical input shapes.  The port builds and runs every arch of the
registry (`models/model.py`).
"""
