"""Command-line entry points of the port (each runs on the card unless given
``--device cpu``):

* ``python -m densefusion_tpu_torch.cli.train``: the two-phase curriculum
  trainer, writing checkpoints the JAX package loads (counterpart of
  ``densefusion_tpu.cli.train``);
* ``python -m densefusion_tpu_torch.cli.eval_linemod``: LineMOD evaluation of
  a checkpoint of either package;
* ``python -m densefusion_tpu_torch.cli.benchmark``: the 1-NN search, the
  train steps of both phases, the loader and loader-fed training.
"""
