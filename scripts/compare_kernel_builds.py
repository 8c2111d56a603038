#!/usr/bin/env python3
"""Time the kernels of this checkout against those of another checkout of
the port, in turns, on one card.

    python scripts/compare_kernel_builds.py OTHER_ROOT [--rounds 4] [--reps 15]
        [--rows 1 2 5 6 7 8 9]

OTHER_ROOT is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into the gitignored ``build/``). Each side's
``ot_vae_tpu_torch/ops/csrc/*.cu`` is built by its own ``ops/_build.py``
into its own ``build/kernels/``, both at once, and each side's wrappers
(``ops/attention.py``, ``ops/sinkhorn.py``) call their own libraries, so
the two sides may differ in a C signature. The rows picked by ``--rows``
(all by default) are then timed at the main paths' largest shapes and the
next ones: in bf16 rows 1 and 5 at the FFHQ128 CNN decoder's 32² block
(T=1024, H=2, ch=64) and the encoder's 16² block (T=256, H=4) at batch 64,
rows 2 and 6 at the same blocks at the train batch of 128, rows 7 and 8 at
the FFHQ128 ViT encoder's (H=4) and decoder's (H=2) layer, T=1024, d=128,
at batches 64 and 32; in f32 row 9 (Sinkhorn) at the MNIST32 transport's
reg, max_iter and threshold on chip_smoke.py's codebook costs at 1 × 256²
(the path's), 64 × 256² and 1 × 1024². Each measurement is
chip_smoke.py's ``time_ms`` (CUDA events, L2 flushed, median of ``--reps``
calls); the sides alternate within each round (this, other; other, this;
...), and a row reports the median over rounds of each side and their
ratio.

Prints the card's name and power limit first and a JSON line of the numbers
last. Needs the CUDA toolkit and one card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextmanager
def resolving(name: str, module):
    """Inside the block the module name ``name`` resolves to ``module``. The
    wrappers' ``_call`` imports its library loader by name at every call
    (``from ot_vae_tpu_torch.ops._build import load_library``), so the other
    side's own ``_call`` then loads the other side's build."""
    saved = sys.modules[name]
    sys.modules[name] = module
    try:
        yield
    finally:
        sys.modules[name] = saved


def cases(attention, gen, rows):
    """[(name, call(side))] of the timed rows, a side holding its
    ``attention`` and ``sinkhorn`` modules; the backward rows' residuals come
    from this checkout's forward"""
    import chip_smoke as cs

    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    out = []
    for t, h in ((1024, 2), (256, 4)):
        ch, c = 64, h * 64
        scale = 1.0 / math.sqrt(ch)
        qkv = randn(64, t, 3 * c)
        out.append((1, f"row 1 B=64 T={t} H={h} C={ch}",
                    lambda a, qkv=qkv, h=h, s=scale: a.attention.attention_packed(qkv, h, s)))
        qkv, dout = randn(128, t, 3 * c), randn(128, t, c)
        o, lse = attention.attention_packed(qkv, h, scale)
        out.append((2, f"row 2 B=128 T={t} H={h} C={ch}",
                    lambda a, r=(qkv, o, lse, dout), h=h, s=scale:
                    a.attention.attention_packed_backward(*r, h, s)))
        for b, row in ((64, 5), (128, 6)):
            x = randn(b, t, c)
            # the model's weights: the 1×1 convs' [out, in] matrices viewed [in, out]
            wq = (torch.randn((3 * c, c), generator=gen, device="cuda") / math.sqrt(c)).t()
            wo = (torch.randn((c, c), generator=gen, device="cuda") / math.sqrt(c)).t()
            name = f"row {row} B={b} T={t} H={h} ch={ch} C={c}"
            if row == 5:
                out.append((5, name, lambda a, r=(x, wq, wo), h=h, s=scale:
                            a.attention.attention_block(*r, h, s)))
            else:
                _, lse = attention.attention_block(x, wq, wo, h, scale)
                out.append((6, name, lambda a, r=(x, wq, wo, lse, randn(b, t, c)), h=h,
                            s=scale: a.attention.attention_block_backward(*r, h, s)))
    for h in (4, 2):
        d, t = 128, 1024
        scale = 1.0 / math.sqrt(d)
        q, k, v = randn(64, t, h * d), randn(64, t, h * d), randn(64, t, h * d)
        out.append((7, f"row 7 B=64 T={t} H={h} d={d}",
                    lambda a, r=(q, k, v), h=h, s=scale: a.attention.attention_bthd(*r, h, s)))
        q, k, v, dout = (randn(32, t, h * d) for _ in range(4))
        o, lse = attention.attention_bthd(q, k, v, h, scale)
        out.append((8, f"row 8 B=32 T={t} H={h} d={d}",
                    lambda a, r=(q, k, v, o, lse, dout), h=h, s=scale:
                    a.attention.attention_bthd_backward(*r, h, s)))
    for batch, n, m in cs.SINKHORN_TIMED:
        inputs = cs.codebook_costs(batch, n, m, 16, seed=batch * 7919 + n)
        out.append((9, f"row 9 B={batch} N={n} M={m} reg 1e-5",
                    lambda a, r=inputs: a.sinkhorn.sinkhorn_log_kernel(*r, **cs.SINKHORN_PATH)))
    return [(name, call) for row, name, call in out if row in rows]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other_root", type=Path, help="root of the other checkout")
    parser.add_argument("--rounds", type=int, default=4, help="rounds of turns")
    parser.add_argument("--reps", type=int, default=15, help="timed calls a measurement")
    parser.add_argument("--rows", type=int, nargs="+", default=[1, 2, 5, 6, 7, 8, 9],
                        help="rows of the kernel table to time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernel_builds: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ot_vae_tpu_torch.ops import _build, attention, sinkhorn

    print(cs.nvidia_smi(), flush=True)
    ops = args.other_root.resolve() / "ot_vae_tpu_torch" / "ops"
    other_build = load_module("other_build", ops / "_build.py")
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda b: b.build_all(), (_build, other_build)))
    print(f"built: this {sorted(built[0])}, other {sorted(built[1])}", flush=True)
    other = SimpleNamespace(attention=load_module("other_attention", ops / "attention.py"),
                            sinkhorn=load_module("other_sinkhorn", ops / "sinkhorn.py"))

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    sides = {"this": SimpleNamespace(attention=attention, sinkhorn=sinkhorn), "other": other}
    results = []
    for name, call in cases(attention, torch.Generator(device="cuda").manual_seed(2468),
                            set(args.rows)):
        times = {side: [] for side in sides}
        for r in range(args.rounds):
            for side in (("this", "other") if r % 2 == 0 else ("other", "this")):
                with (resolving(_build.__name__, other_build) if side == "other"
                      else nullcontext()):
                    times[side].append(cs.time_ms(lambda: call(sides[side]), flush, args.reps))
        row = {"case": name, **{f"{side}_ms": statistics.median(v) for side, v in times.items()},
               "rounds": times}
        row["ratio"] = row["this_ms"] / row["other_ms"]
        results.append(row)
        print(f"{name}: this {row['this_ms']:.4f} ms, other {row['other_ms']:.4f} ms, "
              f"this/other {row['ratio']:.4f} (rounds: this "
              f"{', '.join(f'{v:.4f}' for v in times['this'])}; other "
              f"{', '.join(f'{v:.4f}' for v in times['other'])})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
