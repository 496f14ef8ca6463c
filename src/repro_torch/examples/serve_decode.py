"""Batched serving: prefill a prompt batch on the hybrid (zamba2) smoke model
and decode greedily with the O(1)-state SSM cache (the reference's
``examples/serve_decode.py``), on the card.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu --kernel-backend torch

Any arch of the registry runs here; for the enc-dec (whisper-base) and VLM
(pixtral-12b) archs the batch also carries the stub frontend's audio or
image embeddings, as the reference's example adds them.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.configs import get_smoke_config
from repro_torch.experiments.engine import EngineCapabilityError
from repro_torch.launch.serve import Server, prompt_positions, stub_batch


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
        cfg = get_smoke_config(args.arch)
        srv = Server(args.arch, smoke=True,
                     max_len=prompt_positions(cfg, args.prompt_len) + args.tokens + 8,
                     device=args.device, kernel_backend=args.kernel_backend)
    except EngineCapabilityError as e:
        sys.exit(f"{e.capability.code}: {e}")
    batch = stub_batch(srv.cfg, args.batch, args.prompt_len)
    t0 = time.perf_counter()
    out = srv.generate(batch, args.tokens)
    dt = time.perf_counter() - t0
    print(f"[{args.arch}] generated {out.shape[0]}x{out.shape[1]} tokens "
          f"in {dt:.2f}s ({out.numel() / dt:.1f} tok/s, smoke config on {srv.device})")
    print("first sequence:", out[0, :16].cpu().numpy(), "...")


if __name__ == "__main__":
    main()
