"""Plain PyTorch reference of what the benchmark's cells compute, in
float32 with TF32 off: the decoder language models, dense and the
Mamba2 hybrid (:mod:`.lm`, the ``lm`` kind: a configuration names its
kind, a module here, in its ``reference`` key; see
:mod:`portbench.harness.kinds`), Threefry-2x32 uniforms (:mod:`.threefry`)
and ECD-PSGD's exchange (:mod:`.gossip`), and the training steps, AdamW's
and ECD-PSGD's, whose readings decide a run's ``correct``
(:mod:`.steps`).  The hybrid and the exchange are held to the port by the
tests and wait for cells of their own.  It imports torch alone: nothing of the
program, of JAX or of the JAX package."""
