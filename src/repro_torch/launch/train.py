"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (ports ``repro/launch/train.py``).

The reference's flags and defaults, its data (``lm_batches`` at seed 17,
skipped to the resumed step) and its printed line

    finished at step N (resumed from R); loss A -> B; stragglers: {...}

plus ``--device`` (the card unless ``cpu`` is asked for).  Smoke configs
by default, ``--full`` for the registered width.  Checkpoints land in
``--ckpt-dir`` (by default under the temporary directory) and a rerun
resumes from the newest one; ``--fail-at N`` injects a failure at step N.
``--mesh-shape 2,4`` names its axes ``data, model`` as the reference's
launcher does and trains on that many gloo ranks (``launch.mesh.
run_ranks``, every rank on the card, or on the CPU with ``--device cpu``);
rank 0 prints the line.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import MeshConfig, OptimizerConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.ft.failures import FailureInjector
from repro_torch.launch.mesh import run_ranks
from repro_torch.training.trainer import Trainer, TrainResult


def _train(mesh, cfg: TrainConfig, batch: int, seq: int, fail_at: int,
           device) -> TrainResult:
    """One run of the trainer (on ``mesh``'s rank, or alone)."""
    def data_fn(start_step):
        it = lm_batches(cfg.model.vocab_size, batch, seq, seed=17)
        for _ in range(start_step):      # deterministic resume alignment
            next(it)
        return it

    injector = FailureInjector(fail_at_steps=(fail_at,)) if fail_at else None
    return Trainer(cfg, data_fn, mesh=mesh, failure_injector=injector,
                   device=device).run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    shape = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else (1,)
    cfg = TrainConfig(
        model=mcfg, mesh=MeshConfig(shape=shape, axis_names=(
            "data", "model")[: len(shape)]),
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=10,
                                  decay_steps=args.steps),
        seq_len=args.seq, global_batch=args.batch, steps=args.steps,
        microbatches=args.microbatches, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every)
    run = (cfg, args.batch, args.seq, args.fail_at, args.device)
    if args.mesh_shape:
        res = run_ranks(_train, cfg.mesh, args.device, *run,
                        timeout=24 * 3600)[0]
    else:
        res = _train(None, *run)
    print(f"finished at step {res.final_step} "
          f"(resumed from {res.resumed_from}); "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
          f"stragglers: {res.straggler_summary}")
    return res


if __name__ == "__main__":
    main()
