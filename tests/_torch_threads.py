"""Imported by every ``test_torch_*`` file.  The suite runs several workers
on shared cores: one intra-op thread each keeps PyTorch's CPU kernels from
oversubscribing them."""
import torch

torch.set_num_threads(1)
