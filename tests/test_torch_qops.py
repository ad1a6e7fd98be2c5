"""The port's integer primitives and quantizer against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mobilequant_tpu.ops import qops as J
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.quant.quantizer import fake_quant_weight as j_fqw
from mobilequant_tpu.quant.quantizer import scale_offset_from_min_max as j_so

from mobilequant_tpu_torch.ops import qops as P
from mobilequant_tpu_torch.quant.quantizer import QuantConfig as PQC
from mobilequant_tpu_torch.quant.quantizer import fake_quant_weight as p_fqw
from mobilequant_tpu_torch.quant.quantizer import scale_offset_from_min_max as p_so

WCFGS = {
    "w4_sym_per_channel": dict(bitwidth=4, is_symmetric=True, is_per_channel=True),
    "w8_asym_per_tensor": dict(bitwidth=8),
    "w8_asym_per_channel": dict(bitwidth=8, is_per_channel=True),
}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


@pytest.mark.parametrize("name", list(WCFGS))
def test_pack_weight_bit_exact(name):
    w = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    ref = J.pack_weight(jnp.asarray(w), JQC(**WCFGS[name]))
    out = P.pack_weight(torch.from_numpy(w), PQC(**WCFGS[name]))
    for k in ("wq", "scale", "offset", "colsum"):
        assert tuple(np.shape(ref[k])) == tuple(out[k].shape), k
        _eq(ref[k], out[k])


def test_nibbles_roundtrip_and_layout():
    q = np.random.default_rng(1).integers(0, 16, (2, 8, 16)).astype(np.int8)
    packed = P.pack_nibbles(torch.from_numpy(q))
    _eq(J.pack_nibbles(jnp.asarray(q)), packed)
    _eq(q, P.unpack_nibbles(packed))


def test_quantize_act_and_dynamic_bit_exact():
    x = (np.random.default_rng(2).normal(size=(5, 70)) * 3).astype(np.float32)
    s, o = float(np.float32(6.0 / 255)), 131.0
    _eq(J.quantize_act(jnp.asarray(x), s, o), P.quantize_act(torch.from_numpy(x), s, o))
    qj, sj = J.dynamic_quantize_act(jnp.asarray(x))
    qp, sp = P.dynamic_quantize_act(torch.from_numpy(x))
    _eq(qj, qp)
    _eq(sj, sp)


def test_scale_offset_and_weight_fake_quant_bit_exact():
    w = np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32)
    for kw in WCFGS.values():
        _eq(j_fqw(jnp.asarray(w), JQC(**kw)), p_fqw(torch.from_numpy(w), PQC(**kw)))
    sj, oj = j_so(-1.7, 2.3, JQC(bitwidth=16))
    sp, op = p_so(-1.7, 2.3, PQC(bitwidth=16))
    _eq(sj, sp)
    _eq(oj, op)


@pytest.mark.parametrize("name", list(WCFGS))
def test_int_linear_matches(name):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    x8 = rng.integers(-128, 128, (3, 64)).astype(np.int8)
    s, o = float(np.float32(0.03)), 119.0
    ref = J.int_linear(jnp.asarray(x8), s, o, J.pack_weight(jnp.asarray(w), JQC(**WCFGS[name])),
                       jnp.asarray(b))
    out = P.int_linear(torch.from_numpy(x8), s, o,
                       P.pack_weight(torch.from_numpy(w), PQC(**WCFGS[name])),
                       torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_int_head_linear_matches(bits):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    kw = dict(bitwidth=bits, is_symmetric=True, is_per_channel=True)
    ref = J.int_head_linear(jnp.asarray(x), J.pack_weight(jnp.asarray(w), JQC(**kw)))
    out = P.int_head_linear(torch.from_numpy(x), P.pack_weight(torch.from_numpy(w), PQC(**kw)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_int_matmul_qk_pv_match():
    rng = np.random.default_rng(6)
    q = rng.integers(-128, 128, (1, 2, 6, 16)).astype(np.int8)
    k = rng.integers(-128, 128, (1, 2, 9, 16)).astype(np.int8)
    p = rng.uniform(size=(1, 2, 6, 9)).astype(np.float32)
    args = (0.011, 121.0, 0.013, 133.0)
    ref = J.int_matmul_qk(jnp.asarray(q), jnp.asarray(k), *args)
    out = P.int_matmul_qk(torch.from_numpy(q), torch.from_numpy(k), *args)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref = J.int_matmul_pv(jnp.asarray(p), jnp.asarray(k), 0.02, 126.0)
    out = P.int_matmul_pv(torch.from_numpy(p), torch.from_numpy(k), 0.02, 126.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
