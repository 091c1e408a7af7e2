"""Imported by every ``tests/test_torch_*.py`` before the port: pins
torch to one intra-op thread.

With several intra-op threads, torch's CPU kernels split fp32
reductions (matmuls, sums) by the thread count, so the summation order
of the port's CPU results, and at a near-tie a greedy token or a top-k
selection, would depend on the host's cores.  One thread makes them the
same on every host; it also keeps the test workers, each of which runs
torch and XLA, from oversubscribing the host's cores.  It is set at
import, because every test worker imports every test file."""
import torch

torch.set_num_threads(1)
