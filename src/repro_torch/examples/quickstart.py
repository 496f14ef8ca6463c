"""Quickstart: train a reduced qwen1.5-0.5b with DSAG straggler resilience,
checkpointing it as it goes (the reference's ``examples/quickstart.py``), on
the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

:func:`main` returns the trainer and its history, so a caller can check that
the loss fell; ``--device cpu`` takes the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs.base import TrainConfig
from repro_torch.experiments.engine import EngineConfig
from repro_torch.launch.train import Trainer, TrainerOptions


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    engine = EngineConfig(device=args.device,
                          kernel_backend="cuda" if args.device.startswith("cuda") else "torch")
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainConfig(
            dsag=True,  # the paper's method: masked stale-tolerant updates
            optimizer="adamw",
            learning_rate=1e-3,
            checkpoint_every=50,
        )
        opts = TrainerOptions(
            arch="qwen1.5-0.5b",
            smoke=True,
            steps=150,
            global_batch=8,
            seq_len=128,
            checkpoint_dir=ckpt,
            train_config=tc,
            log_every=25,
            engine=engine,
        )
        trainer = Trainer(opts)
        history = trainer.run()
    masked = sum(1 for m in history["mask_count"] if m < trainer.gs.num_groups)
    print(
        f"\nquickstart done: loss {history['loss'][0]:.3f} -> {history['loss'][-1]:.3f}; "
        f"stragglers masked in {masked}/{len(history['mask_count'])} steps"
    )
    return trainer, history


if __name__ == "__main__":
    main()
