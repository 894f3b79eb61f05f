"""Rank functions of ``tests/test_torch_gloo_gather.py``: gloo CPU ranks
with the port's all-gather route registered for CPU tensors (on the card
it is registered for CUDA tensors, where gloo's coalesced all-gather
faults). Imports no JAX."""
import torch
import torch.distributed as dist


def redistribute(rank: int, world: int, rdv: str, routed: bool):
    """Shard(0) -> Replicate of a [2, 4] block a rank on a 1 x 2 mesh, and
    the route's count of gathers."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as M
    m = M.make_lm_mesh((1, 2), ("data", "model"), backend="gloo",
                       device="cpu", init_method=f"file://{rdv}", rank=rank,
                       timeout=60.0)
    if routed:
        # the route's own kernel, registered for CPU tensors as
        # route_gloo_cuda_all_gather registers it for CUDA ones
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", M._gloo_all_gather, "CPU")
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 100 * rank
    got = DTensor.from_local(x, m, [Replicate(), Shard(0)]).redistribute(
        m, [Replicate(), Replicate()]).to_local()
    full = DTensor.from_local(x, m, [Replicate(), Shard(0)]).full_tensor()
    out = (got.tolist(), full.tolist(), M._gloo_all_gather.calls)
    dist.destroy_process_group()
    return out
