"""Command-line entry points of the port. Those that run a network run on
the card unless given ``--device cpu``:

* ``python -m densefusion_tpu_torch.cli.train``: the two-phase curriculum
  trainer (YCB, LineMOD or CAD), writing checkpoints the JAX package loads
  (counterpart of ``densefusion_tpu.cli.train``);
* ``python -m densefusion_tpu_torch.cli.eval_linemod``,
  ``cli.eval_ycb`` and ``cli.eval_cad``: evaluation of a checkpoint of
  either package; ``cli.score_ycb`` scores existing YCB result directories
  (host only);
* ``python -m densefusion_tpu_torch.cli.visualize``: pose overlays of a
  checkpoint's estimates;
* ``python -m densefusion_tpu_torch.cli.train_seg`` and ``cli.segment``:
  SegNet training (YCB or LineMOD format) and the label / mask writer
  whose ``segnet_results/`` masks ``cli.eval_linemod --mode eval`` reads;
* ``python -m densefusion_tpu_torch.cli.benchmark``: the 1-NN search,
  batched and single-frame inference, the train steps of both phases, the
  loader, loader-fed training and SegNet;
* ``cli.cad_prep``, ``cli.inspect_sample``, ``cli.verify_fat`` and
  ``cli.reconstruct_fat``: dataset tools (host only).
"""
