"""Hold the two decode attention kernels against their plain versions on the
card, at every edition and every cluster size:

    python3 scripts/check_decode_attention.py

csrc/decode_attention.cu (the int8 cache) and csrc/kv4_attention.cu (the
int4 cache) split the positions of one (sequence, kv head) over a
thread-block cluster whose size the wrappers pick from the shapes
(chip_smoke.py checks that choice). This script forces every size the
kernels take (1, 2, 4, 8 blocks) on every (G, hd) edition (G = 1, 2, 4,
6, 8, 16; hd = 64, 128, and 256 for the int8 cache), at valid lengths and chunk
starts that leave stripes empty, on both sides of S/2 for the int4 cache,
with 0, 5 and all staged columns, in the relaxed policy, the strict one and
a strict meta whose fq16(0) is not 0 (every position read); and TinyLlama's
shapes (Hkv 4, G 8, hd 64, S 1024) at B = 1, 4, 32, Gemma-2B's on the
int8 cache (Hkv 1, G 8, hd 256, S 1024) at B = 1, 4, 32, and Qwen2-1.5B's
(Hkv 2, G 6, hd 128, S 1024) at B = 1, 4, 32 on both caches. Every output
must equal the plain version's (error 0). It builds the checkout's kernels (build/mqt_kernels), prints the
card's name and power limit, the number of checks and any that differ, and
exits 1 if one does.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mobilequant_tpu_torch.ops import _build, qops  # noqa: E402
from mobilequant_tpu_torch.ops import decode_attention as DA  # noqa: E402
from mobilequant_tpu_torch.ops import kv4_attention as KV  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
META = [0.05, 130.0, 0.04, 126.0, 0.03, 128.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -40000.0]
META4 = [0.02, 130.0, 0.5, 7.25, 0.4, 7.5, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -40000.0]
SITES = {"relaxed": None,
         "strict": [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, 0.0, 65535.0],
         "strict_all_read": [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, -3.0, 65535.0]}


def meta_of(base, policy):
    m = list(base)
    if SITES[policy]:
        m[6:12] = SITES[policy]
    return m


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    _build.lib()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pick = DA.cluster_size, KV.kv4_cluster_size
    n_checks, bad = 0, []

    def check(tag, run, ref):
        """run() at each forced cluster size against ref"""
        nonlocal n_checks
        for n in CLUSTERS:
            DA.cluster_size = KV.kv4_cluster_size = lambda *a, n=n, **k: n
            out = run()
            DA.cluster_size, KV.kv4_cluster_size = pick
            n_checks += 1
            d = (out - ref).abs().max().item()
            if d != 0 or not bool(torch.isfinite(out).all()):
                bad.append(f"{tag} ncl={n}: {d}")

    def ints(shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int8)

    def int8_cache(B, Hkv, G, hd, S, valid, policy):
        kc, vc, q8 = ints((2, B, Hkv, S, hd)), ints((2, B, Hkv, S, hd)), ints((B, Hkv, G, hd))
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        meta = meta_of(META, policy)
        check(f"decode_attention G={G} hd={hd} B={B} valid={valid} {policy}",
              lambda: DA.decode_attention(q8, kc[1], vc[1], meta, vl),
              DA.decode_attention_plain(q8, kc[1], vc[1], meta, vl))

    def int4_cache(B, Hkv, G, hd, S, cs, pos, mst, policy):
        BH, strict = B * Hkv, policy != "relaxed"
        kp, vp = ints((2, BH, hd, S // 2)), ints((2, BH, hd, S // 2))
        sk, sv = ints((2, BH, cs, hd), hi=-112), ints((2, BH, cs, hd), hi=-112)
        kn, vn, q8 = ints((BH, hd), hi=-112), ints((BH, hd), hi=-112), ints((BH, G, hd))
        args = (q8, kp, vp, qops.kv_colsums_packed(kp), sk, sv, kn, vn, meta_of(META4, policy),
                torch.tensor(pos, dtype=torch.int32, device=dev), mst, 1)
        check(f"kv4_decode_attention G={G} hd={hd} B={B} pos={pos} m={mst} {policy}",
              lambda: KV.kv4_decode_attention(*args, qk_fq_on=strict, pv_fq_on=strict),
              KV.kv4_decode_attention_plain(*args, qk_fq_on=strict, pv_fq_on=strict))

    for policy in SITES:
        for G in DA.GROUPS:
            for hd in (64, 128, 256):
                for B, Hkv, valid, pos in ((1, 2, [5], [3]), (3, 1, [5, 256, 77], [3, 240, 130])):
                    int8_cache(B, Hkv, G, hd, 256, valid, policy)
                    if hd == 256:       # the int4 cache has no hd-256 edition (nor has the JAX one)
                        continue
                    for mst in (0, 5, 16):
                        int4_cache(B, Hkv, G, hd, 256, 16, pos, mst, policy)
        # TinyLlama's shapes
        for B, valid in ((1, [193]), (1, [5]), (4, [1, 15, 16, 17]), (32, [193] * 32)):
            int8_cache(B, 4, 8, 64, 1024, valid, policy)
        # Gemma-2B's shapes (one kv head of 256)
        for B, valid in ((1, [193]), (1, [5]), (4, [1, 15, 16, 17]), (32, [193] * 32)):
            int8_cache(B, 1, 8, 256, 1024, valid, policy)
        for B, pos, mst in ((1, [192], 16), (1, [3], 0), (4, [0, 511, 512, 992], 32),
                            (32, [480 + 3 * b for b in range(32)], 16)):
            int4_cache(B, 4, 8, 64, 1024, 32, pos, mst, policy)
        # Qwen2-1.5B's shapes (two kv heads of 128, G 6)
        for B, valid in ((1, [193]), (1, [5]), (4, [1, 15, 16, 17]), (32, [193] * 32)):
            int8_cache(B, 2, 6, 128, 1024, valid, policy)
        for B, pos, mst in ((1, [192], 16), (1, [3], 0), (4, [0, 511, 512, 992], 32),
                            (32, [480 + 3 * b for b in range(32)], 16)):
            int4_cache(B, 2, 6, 128, 1024, 32, pos, mst, policy)
    print(f"decode attention checks: {n_checks}, differing: {len(bad)}", flush=True)
    for line in bad[:20]:
        print(f"  {line}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
