"""F7's repair on the CPU: ``launch.mesh.route_gloo_cuda_all_gather``.

On the card, gloo's coalesced all-gather (the entry point of the
functional collective DTensor's Shard -> Replicate calls) reads CUDA
tensors as host memory and ends the ranks with SIGSEGV; the route sends
the functional op of a gloo group through ``dist.all_gather_into_tensor``
instead. Here, on two gloo CPU ranks, the same registration made for CPU
tensors must carry DTensor's gathers (``redistribute`` and
``full_tensor``) and give the whole tensor, as the op's own kernel does.
"""
import pytest

import _gather_ranks as ranks
from _lm_mesh_cases import spawn_ranks


@pytest.mark.parametrize("routed", [False, True])
def test_dtensor_gather_through_the_route_gives_the_whole_tensor(
        tmp_path_factory, routed):
    res = spawn_ranks(ranks.redistribute, 2, tmp_path_factory, "gather",
                      routed)
    whole = [[float(c + 4 * i + 100 * r) for c in range(4)]
             for r in range(2) for i in range(2)]
    for got, full, calls in res:
        assert got == whole and full == whole
        assert calls == (2 if routed else 0)
