"""Batched serving: prefill a prompt batch on the hybrid (zamba2) smoke model
and decode greedily with the O(1)-state SSM cache (the reference's
``examples/serve_decode.py``), on the card.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu --kernel-backend torch

Any arch the port serves runs here; the reference's enc-dec (whisper-base)
and VLM (pixtral-12b) branches, which add audio or image embeddings to the
batch, are not ported: those archs exit with ``arch-not-ported``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.experiments.engine import EngineCapabilityError
from repro_torch.launch.serve import Server


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--kernel-backend", default="cuda", choices=["cuda", "torch"])
    args = ap.parse_args(argv)

    try:
        srv = Server(args.arch, smoke=True, max_len=args.prompt_len + args.tokens + 8,
                     device=args.device, kernel_backend=args.kernel_backend)
    except EngineCapabilityError as e:
        sys.exit(f"{e.capability.code}: {e}")
    cfg = srv.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))}
    t0 = time.perf_counter()
    out = srv.generate(batch, args.tokens)
    dt = time.perf_counter() - t0
    print(f"[{args.arch}] generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s ({out.numel() / dt:.1f} tok/s, smoke config on {srv.device})")
    print("first sequence:", out[0, :16].cpu().numpy(), "...")


if __name__ == "__main__":
    main()
