"""Model API over every family of the model zoo, from ``repro.models.model``.

``build_model(cfg)`` returns a :class:`Model` exposing ``init(generator)``,
``num_params()``, ``layout`` (the parameters' :class:`FlatLayout`),
``train_loss(params, batch, *, remat, fused_loss)`` (next-token CE),
``prefill(params, batch, cache_len)`` -> ``(last_logits, cache)``,
``decode_step(params, tokens, cache, index)`` -> ``(logits, cache)`` and
``cache_abstract(batch, cache_len)``.  Batch layouts are the reference's:
``{"tokens": [b, s]}``; the VLM's ``{"tokens": [b, s - n_img],
"image_embed": [b, n_img, d]}`` (the patches prefix the text, and decoding
goes on at position ``s``); the enc-dec ``{"tokens": [b, s], "audio_embed":
[b, encoder_seq, d]}``.  The caches are the reference's
(:func:`cache_abstract`): ``{"k", "v": [L, b, S, kvh, hd]}`` for GQA (and
the VLM), plus ``"cross_k"``, ``"cross_v"`` [L, b, encoder_seq, kvh, hd]
for the enc-dec family (written once at prefill, read at every decode
step), ``{"c_kv", "k_rope"}`` for MLA, the Mamba2 ``{"state" (float32),
"conv"}`` for SSM, and both (``"mamba"``, and ``"shared"`` with one KV cache
per shared-block application) for the hybrid family; ``decode_step`` writes
into them in place.  ``kernel_backend`` says how GQA prefill attention and
whisper's encoder and cross-attention run on the card: ``"cuda"`` through
kernel K6 (default), ``"torch"`` through the reference's plain
``full_attention``; MLA takes the plain attention either way
(``models/attention.py``).  ``train_loss`` always takes the plain attention,
as the reference's does (K6 has no backward and refuses grad), and trains
every family: the MoE's adds ``AUX_LOSS_COEF`` times the experts' aux loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.experiments.engine import CAP_ARCH, refuse
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    FlatLayout,
    ParamDecl,
    _leaves,
    apply_norm,
    embed_decls,
    init_from_decls,
    make_rules,
    mlp_apply,
    mlp_decls,
    norm_decls,
    num_elements,
    set_path,
    specs_from_decls,
    torch_dtype,
    tree_map,
)
from repro_torch.models.sharding import (
    P,
    dp_axes,
    is_sharded,
    local_shape,
    placements,
    shard_batch,
    write_slice,
)
from repro_torch.models.transformer import (
    AUX_LOSS_COEF,
    _remat,
    backbone_forward,
    check_ported,
    embed_inputs,
    fused_next_token_loss,
    layer_params,
    lm_decls,
    lm_logits,
    next_token_loss,
    padded_heads,
    padded_kv_heads,
    stack_decls,
    unstack_layers,
)

# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder
# ---------------------------------------------------------------------------


def encdec_decls(cfg: ModelConfig) -> dict[str, Any]:
    enc_block = {
        "ln1": norm_decls(cfg),
        "attn": attn.gqa_decls(cfg, heads=padded_heads(cfg)),
        "ln2": norm_decls(cfg),
        "mlp": mlp_decls(cfg, swiglu=False),
    }
    dec_block = {
        "ln1": norm_decls(cfg),
        "attn": attn.gqa_decls(cfg, heads=padded_heads(cfg)),
        "ln_x": norm_decls(cfg),
        "cross": attn.gqa_decls(cfg, heads=padded_heads(cfg)),
        "ln2": norm_decls(cfg),
        "mlp": mlp_decls(cfg, swiglu=False),
    }
    return {
        "embed": embed_decls(cfg),
        "enc_pos": ParamDecl((cfg.encoder_seq, cfg.d_model), ("pos", "embed")),
        "pos": ParamDecl((cfg.max_position_embeddings, cfg.d_model), ("pos", "embed")),
        "enc_blocks": stack_decls(enc_block, cfg.encoder_layers),
        "enc_ln_f": norm_decls(cfg),
        "blocks": stack_decls(dec_block, cfg.num_layers),
        "ln_f": norm_decls(cfg),
    }


def model_decls(cfg: ModelConfig) -> dict[str, Any]:
    """The parameter declarations of ``cfg``'s model: the enc-dec tree or
    the decoder-only LM's."""
    return encdec_decls(cfg) if cfg.family == "enc_dec" else lm_decls(cfg)


def _encode(cfg: ModelConfig, params, audio_embed, *, backend: str = "cuda"):
    """The encoder over ``audio_embed`` [b, encoder_seq, d]: learned
    positions, non-causal self-attention without RoPE (K6 on the card with
    the ``"cuda"`` backend), each layer under full remat as the reference's."""
    dtype = torch_dtype(cfg.dtype)
    x = audio_embed.to(dtype) + params["enc_pos"][None].to(dtype)
    positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for lp in unstack_layers(params["enc_blocks"], cfg.encoder_layers):
        def body(carry, lp=lp):
            h = apply_norm(cfg, lp["ln1"], carry)
            carry = carry + attn.gqa_forward(cfg, lp["attn"], h, positions, causal=False,
                                             use_rope=False, backend=backend)
            h = apply_norm(cfg, lp["ln2"], carry)
            return carry + mlp_apply(lp["mlp"], h, swiglu=False)

        x = _remat(body, "full")(x)
    return apply_norm(cfg, params["enc_ln_f"], x)


def _encdec_decoder(cfg: ModelConfig, params, x, positions, enc_out, remat: str,
                    *, backend: str = "cuda"):
    """Full-sequence decoder pass (training): causal self-attention and
    cross-attention over ``enc_out``, then the final norm."""
    for lp in unstack_layers(params["blocks"], cfg.num_layers):
        def body(carry, lp=lp):
            h = apply_norm(cfg, lp["ln1"], carry)
            carry = carry + attn.gqa_forward(cfg, lp["attn"], h, positions, causal=True,
                                             use_rope=False, backend=backend)
            h = apply_norm(cfg, lp["ln_x"], carry)
            ek, ev = attn.encoder_kv(cfg, lp["cross"], enc_out)
            carry = carry + attn.cross_attention_forward(cfg, lp["cross"], h, ek, ev,
                                                         backend=backend)
            h = apply_norm(cfg, lp["ln2"], carry)
            return carry + mlp_apply(lp["mlp"], h, swiglu=False)

        x = _remat(body, remat)(x)
    return apply_norm(cfg, params["ln_f"], x)



def cache_abstract(cfg: ModelConfig, batch: int, cache_len: int, dtype=None) -> dict:
    """The decode cache as meta tensors (shape and dtype, no storage): the
    reference's layout for this architecture."""
    check_ported(cfg)
    dt = torch_dtype(dtype or cfg.dtype)
    L, b, S = cfg.num_layers, batch, cache_len
    kv = (L, b, S, padded_kv_heads(cfg), cfg.resolved_head_dim)

    def sd(shape, d=dt):
        return torch.empty(shape, dtype=d, device="meta")

    if cfg.family == "enc_dec":
        cross = (L, b, cfg.encoder_seq) + kv[3:]
        return {"k": sd(kv), "v": sd(kv), "cross_k": sd(cross), "cross_v": sd(cross)}
    if cfg.use_mla:
        return {"c_kv": sd((L, b, S, cfg.kv_lora_rank)), "k_rope": sd((L, b, S, cfg.qk_rope_dim))}
    if cfg.family in ("ssm", "hybrid"):
        d_inner, h, n = ssm_mod.ssm_dims(cfg)
        c, gn = cfg.ssm_conv - 1, ssm_mod.N_GROUPS * n
        mamba = {"state": sd((L, b, h, cfg.ssm_head_dim, n), torch.float32),
                 "conv": {"x": sd((L, b, c, d_inner)), "B": sd((L, b, c, gn)),
                          "C": sd((L, b, c, gn))}}
        if cfg.family == "ssm":
            return mamba
        groups = cfg.num_layers // cfg.attn_every
        shared = (groups,) + kv[1:]
        return {"mamba": mamba, "shared": {"k": sd(shared), "v": sd(shared)}}
    return {"k": sd(kv), "v": sd(kv)}


def cache_specs(cfg: ModelConfig) -> Any:
    """PartitionSpec tree matching :func:`cache_abstract`: the batch over the
    data-parallel axes, the sequence (or the SSM's heads, or the conv's
    channels) over ``model``."""
    dp = dp_axes()
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    kv = P(None, dp, "model", None, None)
    if cfg.family == "enc_dec":
        cross = P(None, dp, None, None, None)  # enc_seq (1500) not shardable
        return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
    if cfg.use_mla:
        return {"c_kv": P(None, dp, "model", None), "k_rope": P(None, dp, "model", None)}
    ssm_spec = {
        "state": P(None, dp, "model", None, None),
        "conv": {
            "x": P(None, dp, None, "model"),
            "B": P(None, dp, None, None),
            "C": P(None, dp, None, None),
        },
    }
    if cfg.family == "ssm":
        return ssm_spec
    if cfg.family == "hybrid":
        return {"mamba": ssm_spec, "shared": {"k": kv, "v": kv}}
    return {"k": kv, "v": kv}


def sharded_cache(cfg: ModelConfig, b: int, cache_len: int, mesh, device, dtype=None) -> dict:
    """The decode cache of a mesh run: DTensors on the compute mesh ``mesh``
    laid out by :func:`cache_specs` (this rank's batch slice of ``b`` rows,
    the sequence over ``model``), zero, on ``device`` (meta in a dry run)."""
    from torch.distributed.tensor import DTensor

    abstract = cache_abstract(cfg, b, cache_len, dtype)
    specs = cache_specs(cfg)
    out: dict = {}
    for path, t in _leaves(abstract):
        spec = specs
        for key in path:
            spec = spec[key]
        local = torch.zeros(local_shape(t.shape, spec, mesh), dtype=t.dtype, device=device)
        set_path(out, path, DTensor.from_local(local, mesh, placements(spec, mesh),
                                               run_check=False))
    return out


def _layer(cache: dict, i: int) -> dict:
    """Layer (or shared-block group) ``i``'s views of a stacked cache."""
    return tree_map(lambda a: a[i], cache)


def _write_prompt(cache: dict, new: dict, i: int) -> None:
    """Write a prefill's per-layer sequence cache (``[b, s, ...]``) at layer
    ``i`` (on a mesh, each rank its own part of the sequence)."""
    for name, t in new.items():
        write_slice(cache[name][i], 1, 0, t)


def _write_state(cache: dict, new: dict, i: int) -> None:
    """Write a Mamba2 layer's recurrent state and conv tails at layer ``i``."""
    write_slice(cache["state"], 0, i, new["state"][None])
    for name, t in new["conv"].items():
        write_slice(cache["conv"][name], 0, i, t[None])


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    kernel_backend: str = "cuda"

    def __post_init__(self):
        if self.kernel_backend not in ("cuda", "torch"):
            raise ValueError(f"unknown kernel_backend {self.kernel_backend!r}")
        self.decls = model_decls(self.cfg)
        self.layout = FlatLayout.from_decls(self.decls, self.cfg.dtype)

    # -- parameters -------------------------------------------------------
    def init(self, generator: torch.Generator, specs=None, mesh=None) -> Any:
        """Parameters drawn from ``generator``, on its device; with ``specs``
        and ``mesh``, this rank's shard of each (drawn leaf by leaf: the
        values of the unsharded draw)."""
        return init_from_decls(self.decls, generator, self.cfg.dtype, specs, mesh)

    def abstract(self) -> Any:
        """The parameters as meta tensors (shape and dtype, no storage): the
        reference's ``ShapeDtypeStruct`` tree."""
        out: dict = {}
        for path, d in _leaves(self.decls):
            set_path(out, path, torch.empty(d.shape, dtype=torch_dtype(d.dtype or self.cfg.dtype),
                                            device="meta"))
        return out

    def param_specs(self, fsdp: bool = False) -> Any:
        """Each parameter's PartitionSpec (:func:`make_rules`)."""
        return specs_from_decls(self.decls, make_rules(self.cfg, fsdp))

    def num_params(self) -> int:
        return num_elements(self.decls)

    # -- training ----------------------------------------------------------
    def train_loss(self, params, batch, *, remat: str = "full", fused_loss: bool = False):
        """Mean next-token cross-entropy of ``batch["tokens"]`` [b, s] (the
        VLM's over its text positions only, the enc-dec's given the encoded
        ``batch["audio_embed"]``), plus ``AUX_LOSS_COEF`` times the experts'
        load-balance loss for MoE models.

        Logits span the padded vocab (``embed_decls`` rounds it up to 256),
        as the reference's logsumexp does.  Attention is the plain one (the
        reference's ``_attend``), whatever ``kernel_backend`` says.  A batch
        carrying embeddings its family does not take is refused."""
        cfg = self.cfg
        check_ported(cfg)
        self._check_layout(batch)
        tokens = batch["tokens"]
        if cfg.family == "enc_dec":
            enc_out = _encode(cfg, params, batch["audio_embed"], backend="torch")
            x = embed_inputs(cfg, params, tokens)
            positions = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
            x = _encdec_decoder(cfg, params, x, positions, enc_out, remat, backend="torch")
            if fused_loss:
                return fused_next_token_loss(cfg, params, x, tokens)
            return next_token_loss(cfg, lm_logits(cfg, params, x), tokens)
        image = batch.get("image_embed")
        x = embed_inputs(cfg, params, tokens, image_embed=image)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, aux = backbone_forward(cfg, params, x, positions, remat=remat, backend="torch")
        x = apply_norm(cfg, params["ln_f"], x)
        offset = cfg.num_image_tokens if image is not None else 0
        if fused_loss:
            ce = fused_next_token_loss(cfg, params, x, tokens, text_offset=offset)
        else:
            ce = next_token_loss(cfg, lm_logits(cfg, params, x), tokens, text_offset=offset)
        return ce + (AUX_LOSS_COEF * aux if cfg.num_experts else 0.0)

    def _check_layout(self, batch) -> None:
        """Refuse a batch whose embeddings this family does not take: audio
        for all but the enc-dec family (which needs it), images for all but
        the VLM."""
        cfg = self.cfg
        if ("audio_embed" in batch) != (cfg.family == "enc_dec") or (
                "image_embed" in batch and cfg.family != "vlm"):
            raise refuse(CAP_ARCH, f"{cfg.name}: the {cfg.family} family takes no batch of "
                                   f"keys {sorted(batch)}")

    # -- serving: prefill ---------------------------------------------------
    def prefill(self, params, batch, cache_len: int):
        """``batch`` (tokens [b, s], and the family's embeddings) -> (logits
        [b, 1, V], cache padded to ``cache_len``; a recurrent state where the
        family has one)."""
        cfg = self.cfg
        self._check_layout(batch)
        if cfg.family == "enc_dec":
            return self._prefill_encdec(params, batch, cache_len)
        tokens = batch["tokens"]
        x = embed_inputs(cfg, params, tokens, image_embed=batch.get("image_embed"))
        x = shard_batch(x, None, None)
        b, s = x.shape[:2]
        if cfg.family in ("ssm", "hybrid") and s < cfg.ssm_conv - 1:
            raise ValueError(f"a prompt of {s} tokens is shorter than the conv's "
                             f"{cfg.ssm_conv - 1}-token tail")
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self._empty_cache(b, s, cache_len, x)
        if cfg.family in ("ssm", "hybrid"):
            x = self._prefill_recurrent(params, x, positions, cache)
        else:
            for i in range(cfg.num_layers):
                lp = layer_params(params["blocks"], i)
                h = apply_norm(cfg, lp["ln1"], x)
                if cfg.use_mla:
                    y, c = attn.mla_prefill_with_cache(cfg, lp["attn"], h, positions)
                else:
                    y, c = attn.gqa_prefill_with_cache(cfg, lp["attn"], h, positions,
                                                       backend=self.kernel_backend)
                x = x + y
                x = x + self._ffn(lp, apply_norm(cfg, lp["ln2"], x))
                _write_prompt(cache, c, i)
                del lp  # a mesh server's gathered layer, before the next one's
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x[:, -1:]), cache

    def _empty_cache(self, b: int, s: int, cache_len: int, x) -> dict:
        """The decode cache on ``x``'s device, the sequence caches zero past
        the prompt's ``s`` positions (the reference pads the prompt's keys
        with zeros); the rest is written whole by the prefill."""
        cfg = self.cfg
        if is_sharded(x):
            return self._empty_sharded_cache(b, cache_len, x)
        cache = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=x.device),
                         cache_abstract(cfg, b, cache_len, x.dtype))
        if cfg.family != "ssm":
            seq = cache["shared"] if cfg.family == "hybrid" else cache
            for name, t in seq.items():
                if not name.startswith("cross_"):
                    t[:, :, s:].zero_()
        return cache

    def _empty_sharded_cache(self, b: int, cache_len: int, x) -> dict:
        """The decode cache of a mesh run on ``x``'s compute mesh
        (:func:`sharded_cache`)."""
        return sharded_cache(self.cfg, b, cache_len, x.device_mesh, x.to_local().device,
                             x.dtype)

    def _prefill_encdec(self, params, batch, cache_len: int):
        """Encode the audio, then the decoder over the prompt: its self-
        attention keys and values into ``k``/``v``, each layer's projection
        of the encoder's output into ``cross_k``/``cross_v``."""
        cfg = self.cfg
        enc_out = _encode(cfg, params, batch["audio_embed"], backend=self.kernel_backend)
        x = embed_inputs(cfg, params, batch["tokens"])
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self._empty_cache(b, s, cache_len, x)
        for i in range(cfg.num_layers):
            lp = layer_params(params["blocks"], i)
            h = apply_norm(cfg, lp["ln1"], x)
            y, c = attn.gqa_prefill_with_cache(cfg, lp["attn"], h, positions, use_rope=False,
                                               backend=self.kernel_backend)
            x = x + y
            h = apply_norm(cfg, lp["ln_x"], x)
            ek, ev = attn.encoder_kv(cfg, lp["cross"], enc_out)
            x = x + attn.cross_attention_forward(cfg, lp["cross"], h, ek, ev,
                                                 backend=self.kernel_backend)
            x = x + mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], x), swiglu=False)
            _write_prompt(cache, dict(c, cross_k=ek, cross_v=ev), i)
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x[:, -1:]), cache

    def _ffn(self, lp, h):
        """The block's feed-forward: the MoE (aux loss dropped) or the MLP."""
        if self.cfg.num_experts:
            return moe_mod.moe_apply(self.cfg, lp["moe"], h)[0]
        return mlp_apply(lp["mlp"], h, swiglu=self.cfg.mlp_swiglu)

    def _mamba_layer(self, params, x, i: int, cache: dict, decode: bool):
        """Residual Mamba2 layer ``i``: the full sequence (its final state and
        conv tails written at ``i``) or one token against the state at ``i``
        (updated in place)."""
        lp = layer_params(params["blocks"], i)
        h = apply_norm(self.cfg, lp["ln"], x)
        if decode:
            y, st = ssm_mod.mamba_decode_step(self.cfg, lp["mamba"], h, _layer(cache, i))
        else:
            y, st = ssm_mod.mamba_forward(self.cfg, lp["mamba"], h, return_state=True)
        _write_state(cache, st, i)
        return x + y

    def _shared_block(self, params, x, attend):
        """zamba2's shared attention + MLP block; ``attend(h)`` -> (y, kv)."""
        sp = params["shared_attn"]
        y, kv = attend(sp["attn"], apply_norm(self.cfg, sp["ln1"], x))
        x = x + y
        return x + mlp_apply(sp["mlp"], apply_norm(self.cfg, sp["ln2"], x), swiglu=True), kv

    def _prefill_recurrent(self, params, x, positions, cache):
        cfg = self.cfg
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = self._mamba_layer(params, x, i, cache, decode=False)
            return x
        # hybrid: groups of Mamba2 layers, each followed by the shared
        # attention block with its own KV cache
        k = cfg.attn_every
        for g in range(cfg.num_layers // k):
            for i in range(g * k, (g + 1) * k):
                x = self._mamba_layer(params, x, i, cache["mamba"], decode=False)
            x, kv = self._shared_block(params, x, lambda p, h: attn.gqa_prefill_with_cache(
                cfg, p, h, positions, backend=self.kernel_backend))
            _write_prompt(cache["shared"], kv, g)
        return x

    # -- serving: one decode step -------------------------------------------
    def decode_step(self, params, tokens, cache, index: int):
        """tokens [b, 1]; ``index`` positions already in the cache (the VLM's
        image positions included), which is updated in place and returned.
        The enc-dec family reads its cross caches and writes only ``k``/``v``;
        its cross-attention runs through K6 with the ``"cuda"`` backend."""
        cfg = self.cfg
        x = embed_inputs(cfg, params, tokens, offset=index)
        x = shard_batch(x, None, None)
        if cfg.family == "enc_dec":
            for i in range(cfg.num_layers):
                lp, c = layer_params(params["blocks"], i), _layer(cache, i)
                y, _ = attn.gqa_decode_step(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x), c,
                                            index, use_rope=False)
                x = x + y
                x = x + attn.cross_attention_forward(
                    cfg, lp["cross"], apply_norm(cfg, lp["ln_x"], x), c["cross_k"],
                    c["cross_v"], backend=self.kernel_backend)
                x = x + mlp_apply(lp["mlp"], apply_norm(cfg, lp["ln2"], x), swiglu=False)
        elif cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = self._mamba_layer(params, x, i, cache, decode=True)
        elif cfg.family == "hybrid":
            k = cfg.attn_every
            for g in range(cfg.num_layers // k):
                for i in range(g * k, (g + 1) * k):
                    x = self._mamba_layer(params, x, i, cache["mamba"], decode=True)
                x, _ = self._shared_block(params, x, lambda p, h: attn.gqa_decode_step(
                    cfg, p, h, _layer(cache["shared"], g), index))
        else:
            step = attn.mla_decode_step if cfg.use_mla else attn.gqa_decode_step
            for i in range(cfg.num_layers):
                lp = layer_params(params["blocks"], i)
                h = apply_norm(cfg, lp["ln1"], x)
                y, _ = step(cfg, lp["attn"], h, _layer(cache, i), index)
                x = x + y
                x = x + self._ffn(lp, apply_norm(cfg, lp["ln2"], x))
                del lp  # a mesh server's gathered layer, before the next one's
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x), cache

    def cache_abstract(self, batch: int, cache_len: int) -> dict:
        return cache_abstract(self.cfg, batch, cache_len)


def build_model(cfg: ModelConfig, kernel_backend: str = "cuda") -> Model:
    return Model(cfg, kernel_backend)
