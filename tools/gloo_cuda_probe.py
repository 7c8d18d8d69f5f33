"""Which collectives a gloo group carries on CUDA tensors, two ranks
sharing one card: what ``repro_torch.distributed.compat`` may hand gloo
directly and what it must stage through the host (a send or receive).

  python tools/gloo_cuda_probe.py

Each op runs in its own pair of spawned processes, so an op that kills a
rank (gloo aborts on a send from a device pointer; a DTensor gather
crashed) fails only its own line.  Prints the interpreter, torch, CUDA
and the card, ``local_map``'s signature, then one ``RESULT <op> ok`` or
``RESULT <op> FAILED <error>`` line per op.  Needs one card and no JAX.
"""
import inspect
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ["all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "reduce", "gather",
       "scatter", "batch_isend_irecv", "all_reduce_bf16",
       "dt_shard_to_replicate", "dt_partial_to_replicate",
       "dt_partial_to_shard", "dt_shard1_to_shard0", "dt_replicate_to_shard"]


def run(rank, world, port, op):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    x = torch.full((4, 8), float(rank + 1), device=dev)
    if op == "all_reduce":
        y = x.clone(); dist.all_reduce(y); assert y[0, 0].item() == 3
    elif op == "broadcast":
        y = x.clone(); dist.broadcast(y, 0); assert y[0, 0].item() == 1
    elif op == "all_gather":
        ys = [torch.empty_like(x) for _ in range(world)]; dist.all_gather(ys, x)
        assert ys[1][0, 0].item() == 2
    elif op == "all_gather_into_tensor":
        y = torch.empty(world * 4, 8, device=dev); dist.all_gather_into_tensor(y, x)
        assert y[4, 0].item() == 2
    elif op == "reduce_scatter_tensor":
        y = torch.empty(1, 8, device=dev)
        dist.reduce_scatter_tensor(y, torch.ones(world, 8, device=dev)); assert y[0, 0].item() == 2
    elif op == "all_to_all_single":
        y = torch.empty(world, 8, device=dev)
        dist.all_to_all_single(y, torch.full((world, 8), float(rank), device=dev)); assert y[1, 0].item() == 1
    elif op == "reduce":
        y = x.clone(); dist.reduce(y, 0)
    elif op == "gather":
        dist.gather(x, [torch.empty_like(x) for _ in range(world)] if rank == 0 else None, 0)
    elif op == "scatter":
        dist.scatter(torch.empty_like(x), [x.clone() for _ in range(world)] if rank == 0 else None, 0)
    elif op == "batch_isend_irecv":
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        assert y[0, 0].item() == ((rank - 1) % world) + 1
    elif op == "all_reduce_bf16":
        y = x.to(torch.bfloat16); dist.all_reduce(y); assert y[0, 0].item() == 3
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, Replicate, Partial, DTensor
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        w = torch.arange(8 * world * 4, dtype=torch.float32, device=dev).reshape(8, 4 * world)
        dt = DTensor.from_local(w[:, rank * 4:(rank + 1) * 4].contiguous(), mesh, [Replicate(), Shard(1)])
        pt = DTensor.from_local(torch.ones(8, 4 * world, device=dev), mesh, [Replicate(), Partial()])
        rt = DTensor.from_local(w, mesh, [Replicate(), Replicate()])
        if op == "dt_shard_to_replicate":
            assert torch.equal(dt.redistribute(mesh, [Replicate(), Replicate()]).to_local(), w)
        elif op == "dt_partial_to_replicate":
            pt.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        elif op == "dt_partial_to_shard":
            pt.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
        elif op == "dt_shard1_to_shard0":
            dt.redistribute(mesh, [Replicate(), Shard(0)]).to_local()
        elif op == "dt_replicate_to_shard":
            rt.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
    torch.cuda.synchronize()
    dist.barrier()
    if rank == 0:
        print("RESULT", op, "ok", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    from torch.distributed.tensor.experimental import local_map
    print("local_map", inspect.signature(local_map))
    for i, op in enumerate(OPS):
        try:
            mp.spawn(run, args=(2, 29700 + i, op), nprocs=2, join=True)
        except Exception as e:  # noqa: BLE001 - the probe records it
            print("RESULT", op, "FAILED", type(e).__name__, str(e)[-400:], flush=True)
