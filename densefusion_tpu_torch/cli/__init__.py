"""Command-line entry points of the port:

* ``python -m densefusion_tpu_torch.cli.benchmark --what knn``: the 1-NN
  search's time on the card (counterpart of ``densefusion_tpu.cli.benchmark``;
  its other measurements come with their slices).
"""
