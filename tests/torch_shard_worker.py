"""One rank of the port's window-sharded Gauss-Newton step, for
test_torch_window_shard.py.

Each process joins a ``torch.distributed`` gloo group of CPU processes,
takes the whole batch from an .npz file, runs
``mimosa_tpu_torch.parallel.window_shard.distributed_gn_step`` with the
group (its rank is its shard) and writes the whole step it got back to its
own .npz file. It imports neither jax nor the JAX package.

Run: python torch_shard_worker.py <tcp://host:port> <world size> <rank>
     <inputs.npz> <output.npz>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(addr, world, rank, inputs, output):
    import numpy as np
    import torch
    import torch.distributed as dist

    from mimosa_tpu_torch.graph import window as win
    from mimosa_tpu_torch.imu import preintegration as pre
    from mimosa_tpu_torch.parallel import window_shard as ws

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank)
    try:
        a = np.load(inputs)
        t = {k: torch.from_numpy(a[k]) for k in a.files}
        q, p, v, bg, ba, g = (t[k] for k in ("q", "p", "v", "bg", "ba", "g"))
        preints = pre.PreintState(*[t["pre_" + f]
                                    for f in pre.PreintState._fields])
        cfg = win.WindowConfig(K=q.shape[0], damping=float(a["damping"]))
        prior = ws.anchor_prior(q, p, v, bg, ba, g,
                                (q[0], p[0], v[0], bg[0], ba[0], g), cfg)
        dx, dg = ws.distributed_gn_step(q, p, v, bg, ba, g, preints, t["fv"],
                                        t["meas_H"], t["meas_b"], cfg, prior,
                                        group=dist.group.WORLD)
        np.savez(output, dx=dx.numpy(), dg=dg.numpy(),
                 shard=np.asarray(ws.shards(dist.group.WORLD)))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
