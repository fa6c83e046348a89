"""The benchmark's CPU tests run several workers at once: each takes two
threads, so the workers do not starve one another."""

import torch

torch.set_num_threads(2)
