"""dtx-train on the port: train the visual-latent dynamics model.

    python -m detex_tpu_torch.cli.train [--device cuda|cpu] --steps 500 \
        --batch-size 128 --checkpoint-dir ckpt
    torchrun --nproc-per-node 4 -m detex_tpu_torch.cli.train --mesh 2x2

Counterpart of detex_tpu/cli/train.py, with the same flags plus --device
(the card by default; raises where there is none).  Runs the training
loop (mpc/train_loop.py) on the synthetic visual environment.  It joins
the launcher's process group first (parallel/distributed.initialize: a
no-op for a single process), so the same command runs on one card and on
many; --mesh dpxtp splits the ranks between data and tensor parallelism
(default: no mesh).  Rank 0 prints the loss and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import sys

from detex_tpu_torch.mpc import dynamics as D
from detex_tpu_torch.mpc.train_loop import TrainConfig, train
from detex_tpu_torch.parallel import distributed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dtx-train")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--latent-dim", type=int, default=64)
    p.add_argument("--action-dim", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--mesh", default=None,
                   help="mesh shape dpxtp over the launcher's ranks, "
                        "e.g. 4x2 (default: no mesh)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    distributed.initialize(device=args.device)
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    cfg = TrainConfig(
        dynamics=D.DynamicsConfig(image_size=args.image_size,
                                  latent_dim=args.latent_dim,
                                  action_dim=args.action_dim),
        batch_size=args.batch_size, n_steps=args.steps, lr=args.lr,
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, mesh_shape=mesh_shape)
    _, _, loss = train(cfg, device=args.device)
    if distributed.rank() == 0:
        print(f"final loss: {loss:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
