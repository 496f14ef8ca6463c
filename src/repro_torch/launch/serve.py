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

``Server(mesh=)`` serves on a ``(data, model)`` device mesh, one server per
rank (``repro_torch.launch.mesh.RankPool``): the weights placed by
``Model.param_specs(num_params > 1e9)`` and degathered inside each
``generate`` (the reference's dry-run cells degather inside each prefill
and decode step): the prefill gathers the stacked blocks one layer at a
time, as the model reads them, and the decode steps share one gather of
each layer (the prefill's last one included); each data
rank serves its slice of the batch on the ``model`` axis (K6 on its own
heads, the decode cache split over its sequence), and every rank returns
the whole batch's tokens.  The MoE family runs there too: each data rank
routes its slice of the batch, the dispatch chunks and capacity those of the
whole batch, as the reference's (``models/moe.py``); its experts run
expert-parallel (deepseek-v2) or ffn-sharded (grok-1) on the ``model`` axis.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.experiments.engine import (
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
)
from repro_torch.core.dsag_pjit import mesh_sizes
from repro_torch.launch.mesh import card_turns
from repro_torch.models import build_model
from repro_torch.models import sharding
from repro_torch.models.layers import round_up, tree_map


class Server:
    """Greedy generation over one model.

    ``device`` holds weights and cache (default ``"cuda"``; no card raises
    ``cuda-device-unavailable``), ``kernel_backend`` is ``"cuda"`` (prefill
    attention through K6) or ``"torch"`` (the plain attention, on either
    device), and the weights come from the model's init drawn from a
    ``torch.Generator`` seeded with ``seed``; ``dtype`` replaces the
    config's (e.g. ``"float32"``).  With ``mesh`` (a
    ``DeviceMesh``) every rank draws the same weights leaf by leaf and keeps
    its shard of each;
    ``max_len`` is rounded up to a multiple of the ``model`` axis, over
    which the cache's sequence is split.
    """

    def __init__(self, arch: str, *, smoke: bool = True, max_len: int = 256,
                 device: str = "cuda", kernel_backend: str = "cuda", seed: int = 0,
                 mesh=None, dtype: str | None = None):
        cap = engine_capability(EngineConfig(device=device, kernel_backend=kernel_backend))
        if not cap.supported:
            raise EngineCapabilityError(cap)
        self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if dtype is not None:
            self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
        self.model = build_model(self.cfg, kernel_backend=kernel_backend)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.max_len = max_len
        self.mesh = mesh
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if mesh is None:
            self.params = self.model.init(gen)
        else:
            sizes = mesh_sizes(mesh)
            sharding.set_mesh(mesh)
            self.max_len = round_up(max_len, sizes.get("model", 1))
            self.param_specs = self.model.param_specs(self.model.num_params() > 1e9)
            # ranks that share a card draw in turns (a whole leaf at a time)
            shards = card_turns(lambda: self.model.init(gen, self.param_specs, mesh),
                                self.device)
            self.params = _place(shards, self.param_specs, mesh)
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
        if self.mesh is not None:
            return self._generate_sharded(batch, num_tokens)
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

    def _weights(self):
        """The weights degathered to their TP-only layout, as DTensors on the
        compute mesh (the ``model`` axis); the stacked blocks' leaves layer by
        layer, as the model reads them (:class:`_LayerDegather`)."""
        out = {}
        for key, tree in self.params.items():
            specs = self.param_specs[key]
            if key == "blocks":
                out[key] = sharding.map_specs(lambda t, spec: _LayerDegather(
                    t, sharding.P(*tuple(spec)[1:]), self.mesh), tree, specs)
            else:
                out[key] = tree_map(sharding.to_compute_mesh,
                                    sharding.degather(tree, specs, self.mesh))
        return out

    @staticmethod
    def _kept(weights):
        """``weights`` whose blocks keep each layer once gathered: the decode
        steps of one ``generate`` read every layer each, so they share one
        gather of each (the prefill, whose activations are the larger,
        gathers and drops layer by layer, keeping only its last layer, which
        the first decode step reads last)."""
        blocks = tree_map(lambda t: _LayerDegather(t.stored, t.spec, t.mesh, kept=t.kept),
                          weights["blocks"])
        return dict(weights, blocks=blocks)

    def _generate_sharded(self, batch, num_tokens: int) -> torch.Tensor:
        """``generate`` on the mesh: this data rank's slice of the batch, then
        the whole batch's tokens gathered from every data rank."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        cfg, mesh = self.cfg, self.mesh
        idx, n_dp = sharding.dp_coordinate(mesh)
        b = batch["tokens"].shape[0]
        if b % n_dp:
            raise ValueError(f"a batch of {b} does not split over {n_dp} data ranks")
        rows = slice(idx * (b // n_dp), (idx + 1) * (b // n_dp))
        batch = {k: v[rows] for k, v in batch.items()}

        def pick(logits):
            return torch.argmax(sharding.full(logits)[:, -1], dim=-1)[:, None].to(torch.int32)

        # the batch is one token stream over the data-parallel axes
        with implicit_replication(), sharding.token_stream(sharding.dp_axes()):
            t0 = time.perf_counter()
            weights = self._weights()
            logits, cache = self.model.prefill(weights, batch, cache_len=self.max_len)
            tok = pick(logits)
            self._sync()
            t1 = time.perf_counter()
            out = [tok]
            index = prompt_positions(cfg, batch["tokens"].shape[1])
            weights = self._kept(weights)
            for _ in range(num_tokens - 1):
                logits, cache = self.model.decode_step(weights, tok, cache, index)
                tok = pick(logits)
                out.append(tok)
                index += 1
            local = torch.cat(out, dim=1)
            result = DTensor.from_local(local, mesh, sharding.placements(
                sharding.batch_spec(None), mesh), run_check=False).full_tensor()
        self._sync()
        self.timings = {"prefill": t1 - t0, "decode": time.perf_counter() - t1}
        return result


class _LayerDegather:
    """A stacked ``[L, ...]`` leaf of the stored weights (a layer laid out by
    ``spec``) whose layer ``i`` is degathered to its TP-only layout on the
    compute mesh when the model reads it (``leaf[i]``: ``layer_params``), so
    that a rank holds one layer's gathered weights at a time, not the whole
    model's; the last layer, once gathered, is kept (the next reader of the
    stack reads it last), and with ``kept`` (the layers gathered so far)
    every layer is."""

    def __init__(self, stored, spec, mesh, kept: dict | None = None):
        self.stored, self.spec, self.mesh = stored, spec, mesh
        self.keep = kept is not None
        self.kept = dict(kept or {})

    def __getitem__(self, i: int):
        from torch.distributed.tensor import DTensor

        if i in self.kept:
            return self.kept[i]
        # layer i of the rank's shard (the layer dim is never split), as a
        # DTensor laid out by the layer's spec
        layer = DTensor.from_local(self.stored.to_local()[i], self.mesh,
                                   sharding.placements(self.spec, self.mesh), run_check=False)
        out = sharding.to_compute_mesh(sharding.degather(layer, self.spec, self.mesh))
        if self.keep or i == self.stored.shape[0] - 1:
            self.kept[i] = out
        return out


def _place(shards, specs, mesh):
    """This rank's ``shards`` as DTensors laid out by ``specs`` on ``mesh``."""
    from torch.distributed.tensor import DTensor

    return sharding.map_specs(lambda t, spec: DTensor.from_local(
        t, mesh, sharding.placements(spec, mesh), run_check=False), shards, specs)


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
