"""The port's four kernels, held against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_kernels.py does.
The same inputs, made with numpy from a seed, go to both. Float outputs agree
to fp32 rounding (the integer dots are exact on both sides; only the order of
fp32 operations differs); int8 outputs may differ by one quantization step
where a transcendental (exp, sin/cos) or a summation order moves a value
across a rounding boundary, so those tests count such elements.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_prefill_attention as PP
from mobilequant_tpu.ops import pallas_qkv as PQ
from mobilequant_tpu.runtime import engine as E
from mobilequant_tpu.models import get_config
from mobilequant_tpu.models import model as M

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope
from mobilequant_tpu_torch.ops.w13_gate import w13_gate
from mobilequant_tpu_torch.ops.w4a8_matmul import w4a8_matmul, w4a8_matmul_stacked


def _w4_stack(rng, L, K, N, w_spread=1.0):
    """A random stacked W4 pack {wq (L,K/2,N), scale, offset, colsum, bias}
    (numpy), with per-channel scales that keep outputs O(1)."""
    q = rng.integers(0, 16, (L, K, N)).astype(np.int8)
    wq = ((q[:, :K // 2] & 0x0F) | ((q[:, K // 2:] & 0x0F) << 4)).astype(np.uint8).view(np.int8)
    scale = (rng.uniform(0.5, 1.5, (L, 1, N)) * w_spread / (70.0 * 4.6 * math.sqrt(K))).astype(np.float32)
    offset = np.full((L, 1, N), 8.0, np.float32)
    colsum = q.astype(np.float32).sum(axis=1)
    bias = rng.normal(size=(L, N)).astype(np.float32) * 0.1
    return {"wq": wq, "scale": scale, "offset": offset, "colsum": colsum, "bias": bias}


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _th(p):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}


def _int8_close(a, b, max_frac=1e-3):
    """|a-b| <= 1 everywhere and at most max_frac of the elements differ."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    n_diff = int((d > 0).sum())
    assert d.max() <= 1, f"max int8 difference {d.max()}"
    assert n_diff <= max_frac * d.size, f"{n_diff} of {d.size} elements differ"
    return n_diff


@pytest.mark.parametrize("M_", [1, 8, 9, 64, 65])
def test_w4a8_matmul_plain_matches_pallas_stacked(M_):
    rng = np.random.default_rng(M_)
    K, N, L = 256, 512, 2
    p = _w4_stack(rng, L, K, N)
    x = rng.integers(-128, 128, (M_, K)).astype(np.int8)
    xs, xo = float(np.float32(0.02)), 121.0
    ref = PM.w4a8_matmul_stacked(jnp.asarray(x), p["wq"], p["scale"], p["offset"],
                                 p["colsum"], p["bias"], xs, xo, 1,
                                 block_n=256, interpret=True)
    before = w4a8_matmul_stacked.plain_calls
    out = w4a8_matmul_stacked(torch.from_numpy(x), _th(p), xs, xo, 1)
    assert w4a8_matmul_stacked.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_w4a8_matmul_plain_matches_pallas_head_form():
    """The quantized-head use: x_scale 1, x_offset 128, no bias, per-row
    dynamic scales multiplied after (engine.quantized_head_logits)."""
    rng = np.random.default_rng(7)
    K, N = 256, 4096
    p = _w4_stack(rng, 1, K, N)
    x = rng.integers(-127, 128, (2, K)).astype(np.int8)
    ref = PM.w4a8_matmul(jnp.asarray(x), p["wq"][0], p["scale"][0], p["offset"][0],
                         p["colsum"][0], jnp.zeros((N,), jnp.float32), 1.0, 128.0,
                         block_n=4096, interpret=True)
    hp = {k: v[0] for k, v in _th(p).items() if k != "bias"}
    out = w4a8_matmul(torch.from_numpy(x), hp, 1.0, 128.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _rope_rows(T_, hd, rot, B=1):
    cfg = get_config("test-llama").replace(hidden_size=256, num_heads=4,
                                           head_dim=hd,
                                           partial_rotary_factor=rot / hd)
    pos = jnp.broadcast_to(jnp.arange(T_)[None, :], (B, T_))
    cos, sin = M.rope_cos_sin(pos, cfg, jnp.float32)
    return np.array(E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim))


@pytest.mark.parametrize("rot,hd,M_", [
    pytest.param(64, 64, 40, id="gqa_full_rotary"),
    pytest.param(16, 64, 40, id="gqa_partial_rotary"),
    # the tile kernel's row edges (64-row tiles), and its head-dim-256
    # edition (a tile of two 64-column runs, each column beside its partner)
    pytest.param(64, 64, 9, id="gqa_full_rotary_m9"),
    pytest.param(16, 64, 65, id="gqa_partial_rotary_m65"),
    pytest.param(256, 256, 65, id="hd256_paired_m65")])
def test_qkv_rope_plain_matches_pallas(rot, hd, M_):
    rng = np.random.default_rng(rot if M_ == 40 else (rot, hd, M_))
    Hq, Hkv, K, L = (4, 2, 256, 2) if hd == 64 else (2, 1, 256, 2)
    Nq = (Hq + 2 * Hkv) * hd
    p = _w4_stack(rng, L, K, Nq)
    x = rng.integers(-128, 128, (M_, K)).astype(np.int8)
    ofq = np.stack([np.full(Nq, 8.0 / 255, np.float32), np.full(Nq, 128.0, np.float32),
                    np.full(Nq, 255.0, np.float32), np.ones(Nq, np.float32)])
    qd, kvd = Hq * hd, Hkv * hd
    seg = np.concatenate([np.full(qd, 6.0 / 255), np.full(kvd, 7.0 / 255),
                          np.full(kvd, 5.0 / 255)]).astype(np.float32)
    segoff = np.concatenate([np.full(qd, 127.0), np.full(kvd, 130.0),
                             np.full(kvd, 126.0)]).astype(np.float32)
    mask = np.concatenate([np.ones(qd + kvd), np.zeros(kvd)]).astype(np.float32)
    outq = np.stack([seg, segoff, mask])
    cs = _rope_rows(M_, hd, rot)
    hs, ho = float(np.float32(0.02)), 124.0
    ref = PQ.qkv_rope_stacked(jnp.asarray(x), _jx(p), jnp.asarray(ofq), jnp.asarray(outq),
                              jnp.asarray(cs), jnp.asarray([hs, ho], jnp.float32), 1,
                              head_dim=hd, rotary_dim=rot, interpret=True)
    before = qkv_rope.plain_calls
    out = qkv_rope(torch.from_numpy(x), _th(p), torch.from_numpy(ofq),
                   torch.from_numpy(outq), torch.from_numpy(cs), hs, ho, 1, hd, rot)
    assert qkv_rope.plain_calls == before + 1
    _int8_close(out.numpy(), np.asarray(ref))


def _attn_meta(qk_fq, pv_fq):
    return np.asarray([0.011, 120.0, 0.013, 131.0, 0.02, 125.0,
                       80.0 / 65535, 32768.0, 65535.0 if qk_fq else 0.0,
                       1.0 / 65535, 0.0, 65535.0 if pv_fq else 0.0,
                       -40000.0], np.float32)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "relaxed"])
def test_prefill_attention_plain_matches_pallas(strict):
    rng = np.random.default_rng(11 if strict else 12)
    B, Hkv, G, T_, S, hd = 2, 2, 2, 21, 32, 64
    q8 = rng.integers(-128, 128, (B, Hkv, G, T_, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
    meta = _attn_meta(strict, strict)
    positions = np.broadcast_to(np.arange(T_, dtype=np.int32)[None], (B, T_)).copy()
    valid = np.asarray([T_ - 4, T_], np.int32)          # valid_len < T on batch 0
    ref = PP.prefill_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8),
                               jnp.asarray(meta), jnp.asarray(positions),
                               jnp.asarray(valid), qk_fq=strict, pv_fq=strict,
                               interpret=True)
    before = prefill_attention.plain_calls
    out = prefill_attention(torch.from_numpy(q8), torch.from_numpy(k8),
                            torch.from_numpy(v8), [float(v) for v in meta],
                            torch.from_numpy(positions), torch.from_numpy(valid),
                            qk_fq=strict, pv_fq=strict)
    assert prefill_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act,site_on", [("silu", (True,) * 4),
                                         ("silu", (False, True, False, True)),
                                         ("gelu_tanh", (True, False, True, True))],
                         ids=["silu_all_sites", "silu_w1_act_sites_off", "gelu_tanh"])
def test_w13_gate_plain_matches_pallas(act, site_on):
    rng = np.random.default_rng(sum(site_on))
    K, F, L, M_ = 256, 512, 2, 48
    p = _w4_stack(rng, L, K, 2 * F, w_spread=3.0)
    x = rng.integers(-128, 128, (M_, K)).astype(np.int8)
    meta = np.zeros(32, np.float32)
    meta[0:2] = [0.02, 126.0]                          # MLP-input encoding
    meta[2:5] = [8.0 / 255, 128.0, 255.0]              # w1 output fq
    meta[5:8] = [1.0 / 255, 0.0, 255.0]                # sigmoid fq
    meta[8:11] = [6.0 / 255, 100.0, 255.0]             # act output fq
    meta[11:14] = [8.0 / 255, 128.0, 255.0]            # w3 output fq
    meta[14:16] = [10.0 / 255, 128.0]                  # w2-input encoding
    ref = PMLP.w13_gate_stacked(jnp.asarray(x), _jx(p), jnp.asarray(meta), 1, act,
                                site_on=site_on, interpret=True)
    before = w13_gate.plain_calls
    out = w13_gate(torch.from_numpy(x), _th(p), [float(v) for v in meta], 1,
                   act, site_on=site_on)
    assert w13_gate.plain_calls == before + 1
    _int8_close(out.numpy(), np.asarray(ref))


def test_kernel_registry_counts_reset():
    T_ops.reset_counts()
    assert set(T_ops.counts()) == {"w4a8_matmul", "w4a8_matmul_stacked", "w8a8_matmul", "qkv_rope",
                                   "prefill_attention", "w13_gate", "fused_mlp_block_w4", "fused_layer_w4",
                                   "fused_model_w4", "staged_append", "fused_otail_block_w4",
                                   "fused_model_w4_chunk", "kv4_decode_attention",
                                   "decode_attention", "wonly_matmul_stacked", "w4a16_matmul",
                                   "fused_mlp", "fused_mlp_block", "w13_gate_w2"}
    assert all(v == 0 for v in T_ops.counts().values())
    assert all(v == 0 for v in T_ops.counts("plain_calls").values())


def test_kernel_paths_refuse_foreign_devices():
    """A wrapper runs its plain version only for CPU tensors and raises on a
    device it has no kernel for (here: the meta device)."""
    x = torch.zeros((1, 64), dtype=torch.int8, device="meta")
    pack = {"wq": torch.zeros((32, 128), dtype=torch.int8, device="meta"),
            "scale": torch.ones((1, 128), device="meta"),
            "offset": torch.zeros((1, 128), device="meta"),
            "colsum": torch.zeros((128,), device="meta")}
    with pytest.raises(ValueError):
        w4a8_matmul(x, pack, 1.0, 128.0)
    from mobilequant_tpu_torch.ops.decode_attention import decode_attention
    from mobilequant_tpu_torch.ops.kv4_attention import kv4_decode_attention
    meta = [1.0] * 12 + [-40000.0]
    q = torch.zeros((2, 2, 4, 64), dtype=torch.int8, device="meta")
    kv = torch.zeros((2, 2, 16, 64), dtype=torch.int8, device="meta")
    valid = torch.ones((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, meta, valid)
    kp = torch.zeros((1, 4, 64, 8), dtype=torch.int8, device="meta")
    st = torch.zeros((1, 4, 2, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        kv4_decode_attention(q.reshape(4, 4, 64), kp, kp,
                             torch.zeros((1, 4, 16), device="meta"), st, st,
                             torch.zeros((4, 64), dtype=torch.int8, device="meta"),
                             torch.zeros((4, 64), dtype=torch.int8, device="meta"), meta,
                             valid, 0, 0)
