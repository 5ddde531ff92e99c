"""PyTorch port of `repro`, the dataset-characters scalability study.

The package mirrors the JAX reference's module layout (``data``, ``core``,
``kernels``, ``analysis``, ``experiments``, ``configs``, ``models``,
``serve``, ``launch``) so each module's counterpart is found by path.  It
runs on an NVIDIA GPU by default: entry points take ``device="cuda"`` and
raise when no GPU is present unless the caller asks for the CPU
explicitly.  Hand-written CUDA kernels in ``kernels/csrc`` carry the
L0-distance characters, ECD-PSGD's stochastic quantization, and the
language model's RMSNorm and flash attention; their plain PyTorch
versions serve CPU tensors and act as the kernels' oracles.
"""

from repro_torch.device import resolve_device  # noqa: F401

#: the reference's modules with no port of that name, and why: every other
#: module of ``repro`` has a counterpart here by path, and every name a
#: ``repro`` package exports resolves in the port's package of that path
#: (``tests/test_torch_surface.py`` reads this list)
NOT_PORTED = {
    "kernels.ops": "the jnp / Pallas dispatch of the reference's kernels; "
                   "the port's wrappers live beside each kernel "
                   "(kernels/csim.py, quantize.py, rmsnorm.py, "
                   "flash_attention.py)",
    "kernels.ref": "the reference's pure-jnp kernel references; each port "
                   "kernel module holds its plain PyTorch version",
    "launch.hlo_stats": "parses compiled HLO text, which an eager port has "
                        "none of; launch/comm_stats.py records the same "
                        "statistics as the step runs",
}

_GEN = ("takes a torch.Generator (``gen``, or ``generator`` and "
        "``device``) where the reference takes a PRNG ``key``: weights are "
        "drawn by torch's generators on the target device")
_KERNEL = ("has no ``use_kernel``: the port picks the L0 kernel by the "
           "tensor's device (K1/K2 on a CUDA tensor, the plain version on "
           "the CPU)")
_RUNNER = ("the reference's deprecated per-m runner is defined in "
           "core/algorithms/runners.py and exported by "
           "repro_torch.core.algorithms, not in the algorithm's module")

#: ``"module.name"`` of every public function or class of ``repro`` whose
#: port differs in its parameters (a reference parameter missing, renamed
#: or out of the reference's order) or is not defined in the module of
#: that path, and why; every other one takes the reference's parameters
#: by the same names in the same order (``tests/test_torch_signatures.py``
#: reads this dict and fails on an entry that no longer differs)
SIGNATURE_DIFFERENCES = {
    "core.algorithms.dadm.run_dadm": _RUNNER,
    "core.algorithms.ecd_psgd.run_ecd_psgd": _RUNNER,
    "core.algorithms.hogwild.run_hogwild": _RUNNER,
    "core.algorithms.minibatch.run_minibatch": _RUNNER,
    "core.algorithms.hogwild.masked_sim":
        "the reference's traced-m simulation factory for jit; the port's "
        "Hogwild! runs as the registered Hogwild algorithm through the "
        "engine, which pads and masks m itself",
    "core.algorithms.hogwild.run_hogwild_sharded":
        "the reference's alias of distributed.hogwild_shards."
        "run_hogwild_sharded; the port defines it there only",
    "core.compression.quantize_error":
        "takes the uniform noise ``u`` where the reference takes a PRNG "
        "key: the caller draws it (random.uniform), so the CUDA quantizer "
        "and its plain version read the same numbers",
    "core.compression.quantize_stochastic":
        "takes the uniform noise ``u`` where the reference takes a PRNG "
        "key: the caller draws it (random.uniform), so the CUDA quantizer "
        "and its plain version read the same numbers",
    "core.metrics.batch_internal_similarity": _KERNEL,
    "core.metrics.csim": _KERNEL,
    "core.metrics.ls_async": _KERNEL,
    "core.metrics.ls_auto": _KERNEL,
    "core.metrics.ls_sync": _KERNEL,
    "distributed.mesh.DeviceMesh":
        "holds the tuple of torch ``devices`` its shards run on where the "
        "reference wraps a jax Mesh (``mesh``)",
    "distributed.partition.run_grid_sharded":
        "takes ``run_elements`` (runs a batch of grid elements on one "
        "device) where the reference takes ``make_sim_elem`` and "
        "``jit_fn``: there is nothing to trace or jit, shards run one "
        "after another",
    "experiments.engine.sweep":
        "has ``per_m`` where the reference has ``use_vmap``, its "
        "negation: the engine always batches the grid as tensors, and "
        "per_m=True runs each m alone as use_vmap=False does",
    "experiments.runner.run_sweep":
        "has ``per_m`` where the reference has ``use_vmap`` (as "
        "engine.sweep), and takes ``device``",
    "models.attention.init_cross_attn": _GEN,
    "models.attention.init_gqa": _GEN,
    "models.attention.init_mla": _GEN,
    "models.layers.init_embedding": _GEN,
    "models.layers.init_learned_positions": _GEN,
    "models.layers.init_mlp": _GEN,
    "models.model.init_params": _GEN,
    "models.model.init_shared_attn": _GEN,
    "models.moe.init_moe": _GEN,
    "models.ssm.init_mamba2": _GEN,
    "models.ssm.init_mlstm": _GEN,
    "models.ssm.init_slstm": _GEN,
    "train.steps.init_gossip_state": _GEN,
    "train.steps.init_train_state": _GEN,
    "telemetry.instrument.dispatch":
        "names its callable ``fn``, where the reference's is a jitted "
        "``jfn``: the port calls a plain function",
}
