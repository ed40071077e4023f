"""Train a small LM for a few hundred steps with the PyTorch port's full
loop: the remat'd train step, AdamW and its schedule, atomic checkpoints,
auto-resume (the port's counterpart of ``examples/train_tiny_lm.py``).

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 200] \\
        [--device cpu]

Interrupt it (Ctrl-C) and run again: it resumes from the last checkpoint.
Without ``--device`` it runs on the card.
"""
import argparse
import os
import tempfile

from repro_torch.config import OptimizerConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import lm_batches
from repro_torch.training.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    mcfg = get_smoke_config(args.arch)
    cfg = TrainConfig(
        model=mcfg,
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                  decay_steps=args.steps),
        seq_len=64, global_batch=8, steps=args.steps,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=50)

    def data_fn(start):
        it = lm_batches(mcfg.vocab_size, cfg.global_batch, cfg.seq_len,
                        seed=11)
        for _ in range(start):
            next(it)
        return it

    res = Trainer(cfg, data_fn, device=args.device).run()
    print(f"\ntrained to step {res.final_step} "
          f"(resumed from {res.resumed_from})")
    print(f"loss: {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
    print(f"stragglers: {res.straggler_summary}")


if __name__ == "__main__":
    main()
