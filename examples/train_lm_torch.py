"""End-to-end example on the PyTorch port: train a ~100M-param LM with
top-k selective attention for a few hundred steps on synthetic data,
with checkpointing and restart support.

Config: 12L, d_model=768, 12 heads, d_ff=3072, vocab 32k → ~124M params
(GPT-2-small-class).  Top-k attention (k=32) is the SATA workload; the
same model runs dense attention with --dense for an accuracy A/B.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
          [--device cpu] [--ckpt-dir DIR]
(checkpoints go to build/sata_lm100m beside the repo's sources unless
--ckpt-dir says otherwise; a second run with the same directory resumes
from its latest step)
"""
import argparse
import os

from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig
import repro_torch.configs.archs as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lm100m(dense: bool = False) -> ModelConfig:
    return ModelConfig(
        name="lm100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32000,
        head_dim=64, attention_variant="dense" if dense else "topk",
        topk_k=32, q_chunk=128, dtype="float32", remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "sata_lm100m"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (the CPU only when asked)")
    args = ap.parse_args(argv)

    cfg = lm100m(args.dense)
    # register so the generic launcher can use it (mutate in place — the
    # launcher holds a direct reference to this dict)
    A.SMOKE["lm100m"] = cfg
    out = train("lm100m", smoke=True, steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                log_every=10, device=args.device)
    n_params = sum(t.numel() for t in
                   out["final_state"]["params"].parameters())
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.0f}M params, "
          f"attention={cfg.attention_variant}, device={args.device}")
    ls = out["losses"]
    print(f"[train_lm] loss {ls[0]:.3f} → {ls[-1]:.3f} over {len(ls)} steps "
          f"({out['stragglers']} straggler steps flagged; mean step "
          f"{sum(out['step_s']) / len(ls):.3f} s)")
    if args.steps >= 50:          # short runs sit inside LR warmup
        assert min(ls[-10:]) < ls[0], "loss did not decrease"


if __name__ == "__main__":
    main()
