"""Batched serving: prefill a prompt batch, then decode greedily, from
``repro.launch.serve``.

On the card by default, with GQA prefill attention through CUDA kernel K6;
``--device cpu --kernel-backend torch`` runs the plain path on the CPU.
``--arch`` takes every arch of ``repro_torch.configs.ARCHS``: the dense
(qwen1.5-0.5b, qwen2-7b), MoE (grok-1-314b; deepseek-v2-236b with MLA), SSM
(mamba2-370m) and hybrid (zamba2-2.7b) families.  Without ``--full`` it
serves the arch's smoke config, as the reference's CLI does; with it, the
published widths and depth (one card holds neither MoE model whole).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --kernel-backend torch
  PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 --prompt-len 2048 --tokens 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.experiments.engine import (
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
)
from repro_torch.models import build_model


class Server:
    """Greedy generation over one model.

    ``device`` holds weights and cache (default ``"cuda"``; no card raises
    ``cuda-device-unavailable``), ``kernel_backend`` is ``"cuda"`` (prefill
    attention through K6) or ``"torch"`` (the plain attention, on either
    device), and the weights come from the model's init drawn from a
    ``torch.Generator`` seeded with ``seed``.
    """

    def __init__(self, arch: str, *, smoke: bool = True, max_len: int = 256,
                 device: str = "cuda", kernel_backend: str = "cuda", seed: int = 0):
        cap = engine_capability(EngineConfig(device=device, kernel_backend=kernel_backend))
        if not cap.supported:
            raise EngineCapabilityError(cap)
        self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        self.model = build_model(self.cfg, kernel_backend=kernel_backend)
        self.device = torch.device(device)
        self.max_len = max_len
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = self.model.init(gen)
        #: host seconds of the last ``generate``: prefill and all decode steps
        self.timings: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch, num_tokens: int) -> torch.Tensor:
        """Greedy generation; returns [b, num_tokens] int32 token ids.

        The argmax runs over the padded vocab, as the reference's does.
        """
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(device=self.device, dtype=torch.int32)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, {"tokens": tokens},
                                           cache_len=self.max_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        index = tokens.shape[1]
        for _ in range(num_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache, index)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(tok)
            index += 1
        result = torch.cat(out, dim=1)
        self._sync()
        self.timings = {"prefill": t1 - t0, "decode": time.perf_counter() - t1}
        return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="serve the published config (default: the smoke config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--kernel-backend", default="cuda", choices=["cuda", "torch"],
                    help="prefill attention through the CUDA kernel (default) or "
                         "the plain torch attention")
    args = ap.parse_args(argv)
    srv = Server(args.arch, smoke=not args.full,
                 max_len=args.prompt_len + args.tokens + 8, device=args.device,
                 kernel_backend=args.kernel_backend, seed=args.seed)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, srv.cfg.vocab_size, (args.batch, args.prompt_len))}
    t0 = time.perf_counter()
    toks = srv.generate(batch, args.tokens)
    dt = time.perf_counter() - t0
    print(f"[serve] {srv.cfg.name} on {srv.device}: generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s; prefill "
          f"{srv.timings['prefill']:.3f}s, decode {srv.timings['decode']:.3f}s)")
    print(toks[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
