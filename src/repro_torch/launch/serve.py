"""Batched serving: prefill a prompt batch, then decode greedily, from
``repro.launch.serve``.

On the card by default, with GQA prefill attention through CUDA kernel K6;
``--device cpu --kernel-backend torch`` runs the plain path on the CPU.
``--arch`` takes every arch of ``repro_torch.configs.ARCHS``: the dense
(qwen1.5-0.5b, qwen2-7b, qwen1.5-32b, starcoder2-15b), MoE (grok-1-314b;
deepseek-v2-236b with MLA), SSM (mamba2-370m), hybrid (zamba2-2.7b), VLM
(pixtral-12b) and enc-dec (whisper-base) families; for the last two the CLI
adds stub image or audio embeddings to the batch, as the reference's does.
Without ``--full`` it serves the arch's smoke config, as the reference's CLI
does; with it, the published widths and depth (one card holds neither MoE
model, nor qwen1.5-32b, whole).

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

        ``batch`` holds ``tokens`` and, for the VLM and enc-dec families,
        ``image_embed`` or ``audio_embed`` (numpy or tensors); decoding
        starts after the prompt's positions, the VLM's image prefix
        included.  The argmax runs over the padded vocab, as the reference's
        does.
        """
        cfg = self.cfg
        batch = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                 for k, v in batch.items()}
        batch = {k: v.to(self.device) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].to(torch.int32)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(self.params, batch, cache_len=self.max_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        index = prompt_positions(cfg, batch["tokens"].shape[1])
        for _ in range(num_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache, index)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(tok)
            index += 1
        result = torch.cat(out, dim=1)
        self._sync()
        self.timings = {"prefill": t1 - t0, "decode": time.perf_counter() - t1}
        return result


def prompt_positions(cfg, prompt_len: int) -> int:
    """Cache positions a prompt of ``prompt_len`` tokens fills: the VLM's
    image prefix comes first."""
    return prompt_len + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def stub_batch(cfg, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """A prompt batch as the reference's CLI draws it from
    ``np.random.default_rng(seed)``: tokens, then for the enc-dec family
    ``audio_embed`` [b, encoder_seq, d] and for the VLM ``image_embed`` [b,
    num_image_tokens, d], normal draws times 0.1 in bfloat16 (the stub
    frontends)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    n = {"enc_dec": cfg.encoder_seq, "vlm": cfg.num_image_tokens}.get(cfg.family)
    if n is not None:
        key = "audio_embed" if cfg.family == "enc_dec" else "image_embed"
        out[key] = torch.as_tensor(rng.normal(size=(batch, n, cfg.d_model)) * 0.1).to(
            torch.bfloat16)
    return out


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
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    srv = Server(args.arch, smoke=not args.full,
                 max_len=prompt_positions(cfg, args.prompt_len) + args.tokens + 8,
                 device=args.device, kernel_backend=args.kernel_backend, seed=args.seed)
    batch = stub_batch(srv.cfg, args.batch, args.prompt_len)
    t0 = time.perf_counter()
    toks = srv.generate(batch, args.tokens)
    dt = time.perf_counter() - t0
    print(f"[serve] {srv.cfg.name} on {srv.device}: generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s; prefill "
          f"{srv.timings['prefill']:.3f}s, decode {srv.timings['decode']:.3f}s)")
    print(toks[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
