"""How far the port's and the JAX package's training loops drift apart from
the same state (the CPU; about two minutes).

    JAX_PLATFORMS=cpu python scripts/quant_train_drift.py

test-llama cut to 2 layers, the W4A8 policy (per-channel symmetric W4, A8),
the JAX pipeline's calibrated ranges and SmoothQuant LET init on 8 x 16
random tokens, carried into the port (convert.from_jax_qstate). For the
strict and the relaxed policy, with LRL (the ranges trained) and without,
prints the largest per-leaf max |port - JAX| / max |JAX| of the state after
three e2equant steps (batches of 2) and after omniquant (2 epochs of 2
batches on 4 samples), and the leaf it is on.
"""

import dataclasses

import numpy as np

import jax

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant import calibrate as j_cal
from mobilequant_tpu.quant import policy as j_pol
from mobilequant_tpu.quant import smooth as j_sm
from mobilequant_tpu.quant import train as j_tr
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC

from mobilequant_tpu_torch.convert import from_jax_params, from_jax_qstate, qstate_to_numpy
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant import policy as pol, train
from mobilequant_tpu_torch.quant.quantizer import QuantConfig


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def worst(a, b):
    a, b = flat(a), flat(b)
    return max((float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)), k)
               for k in b)


def main():
    jcfg = dataclasses.replace(j_get_config("test-llama"), num_layers=2)
    cfg = dataclasses.replace(get_config("test-llama"), num_layers=2)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    w4 = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)
    jstrict = j_pol.default_policy(jcfg, JQC(**w4), JQC(bitwidth=8))
    tstrict = pol.default_policy(cfg, QuantConfig(**w4), QuantConfig(bitwidth=8))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    st = j_cal.run_calibration(jp, toks, jcfg, jstrict, batch_size=4)
    ranges = j_cal.stats_to_ranges(st, jstrict)
    let0 = j_sm.smoothquant_let_init(jcfg, *j_cal.smooth_calib_inputs(st), jp)
    for name, jpol_, tpol_ in (("strict", jstrict, tstrict),
                               ("relaxed", j_pol.relax_16bit(jstrict),
                                pol.relax_16bit(tstrict))):
        for lrl in (True, False):
            for loop, kw, n in (("e2equant", dict(epochs=1, batch_size=2), 6),
                                ("omniquant", dict(epochs=2, batch_size=2), 4)):
                jtc = j_tr.TrainConfig(use_lrl=lrl, **kw)
                ttc = train.TrainConfig(use_lrl=lrl, **kw)
                jq = j_tr.init_qstate(jp, jcfg, jpol_, jtc, ranges, let=let0)
                tq = from_jax_qstate(jax.tree.map(np.asarray, jq), "cpu")
                jrun = j_tr.e2equant if loop == "e2equant" else j_tr.omniquant
                trun = train.e2equant if loop == "e2equant" else train.omniquant
                jout, _ = jrun(jp, jq, toks[:n], jcfg, jpol_, jtc)
                tout, _ = trun(tp, tq, toks[:n], cfg, tpol_, ttc)
                rel, leaf = worst(qstate_to_numpy(tout), jax.tree.map(np.asarray, jout))
                print(f"{name:7s} LRL {'on ' if lrl else 'off'} {loop:9s}: {rel:.3g} ({leaf})",
                      flush=True)


if __name__ == "__main__":
    main()
