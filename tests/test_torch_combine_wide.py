"""The combine slice at V = 130 validators (T = 2): the port's SigAgg →
dispatch → api → CUDABackend(device="cpu") against the JAX package's
tbls.api.threshold_combine on its "cpu" backend, byte for byte, with the
full 87 Straus windows.  Its own file: the pure-Python JAX oracle and the
plain versions each take about half a minute here.
"""

import torch

# one intra-op thread: the suite runs several workers on the same cores,
# and spinning torch threads in each of them slow every worker down
torch.set_num_threads(1)

from test_torch_combine import _check_against_jax, port_backend  # noqa: F401


def test_sigagg_equals_jax_cpu_backend_130_validators(port_backend):  # noqa: F811
    _check_against_jax(130, 2)
