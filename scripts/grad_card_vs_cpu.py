"""The unsharded port's group gradients of qwen1.5-0.5b at full width and 2
layers, float32, on the card against the same on the CPU, on the first
batch of ``chip_smoke.py`` phase 18 (random init, seed 0): per leaf the
largest difference, and the embedding's rows that differ most relative to
their own largest value.  At random init the attention is near one-hot and
the gradient ill-conditioned: this is the yardstick for phase 18's int8
slot bound.  Run on a machine with a card:

    python3 scripts/grad_card_vs_cpu.py
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the repo
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from repro_torch.core.dsag_pjit import autograd_group_value_and_grad
    from repro_torch.models import build_model

    cfg = dataclasses.replace(cs._cut_config(2)(cs.MESH_ARCH), dtype="float32")
    batch = cs.mesh_batches(torch, cfg, 2)[0]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, kernel_backend="cuda" if dev == "cuda" else "torch")
        gen = torch.Generator(device="cuda").manual_seed(0)
        tree = model.init(gen)
        flat = model.layout.flatten(tree).to(dev)
        fn = autograd_group_value_and_grad(lambda p, b: model.train_loss(p, b, remat="full"),
                                           model.layout)
        losses, grads = fn(flat, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        out[dev] = (losses.cpu(), grads.cpu(), model)
        print(dev, losses)
    model = out["cpu"][2]
    gc, gg = out["cuda"][1], out["cpu"][1]
    for x, a, b in zip(model.layout.leaves, model.layout.views(gc), model.layout.views(gg)):
        d = (a - b).abs()
        rel = float(d.max() / b.abs().max().clamp_min(1e-30))
        print(x.path, tuple(a.shape), "max |cuda-cpu|", float(d.max()), "rel to max", rel)
        if x.path == ("embed", "tok"):
            row = d.amax(-1) / b.abs().amax(-1).clamp_min(1e-30)
            top = torch.topk(row.flatten(), 5)
            print("  worst rows (rel to the row's max):", top.values.tolist(),
                  [divmod(int(i), row.shape[-1]) for i in top.indices])
            grp, tok = divmod(int(top.indices[0]), row.shape[-1])
            print(f"  the worst row, group {grp} token {tok}: card {a[grp, tok, :6].tolist()}, "
                  f"CPU {b[grp, tok, :6].tolist()}; the token's count in the group's batch "
                  f"{int((torch.as_tensor(batch['tokens'])[grp] == tok).sum())}")


if __name__ == "__main__":
    main()
