"""How far a random quantized model moves its logits under rounding, in the
JAX package and the port alike (the CPU; about half a minute).

    JAX_PLATFORMS=cpu python scripts/quant_sim_sensitivity.py

test-llama at hidden 512 (8 q / 2 kv heads of 64, F 1408, vocab 2048, 2
layers), the port's seeded FP params, the strict W4A8 policy, ranges
calibrated on 8 x 64 synthetic tokens by each package (they differ by a few
ulps: their statistics pass through fp32 matmuls in different orders).
Prints, on a 12-token prompt, max |a - b| / max |b| of the logits:
  * the port's sim and engine against the JAX package's, on the same ranges;
  * the JAX sim on the port's ranges against the JAX sim on its own;
  * the engine against the sim, in each package, on each set of ranges.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.quant import calibrate as j_cal
from mobilequant_tpu.quant import qmodel as j_qm
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.convert import from_jax_qstate, qstate_to_numpy
from mobilequant_tpu_torch.data.calib import synthetic_tokens
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant import calibrate, qmodel
from mobilequant_tpu_torch.quant.policy import default_policy
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def main():
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_size=512,
                               intermediate_size=1408, num_heads=8, num_kv_heads=2,
                               head_dim=64, vocab_size=2048, num_layers=2)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tokens = synthetic_tokens(cfg.vocab_size, 8, 64)
    tp = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(jnp.asarray, qstate_to_numpy(tp))
    w4 = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)
    jpol = j_default_policy(jcfg, JQC(**w4), JQC(bitwidth=8))
    tpol = default_policy(cfg, QuantConfig(**w4), QuantConfig(bitwidth=8))
    j_ranges = j_cal.stats_to_ranges(j_cal.run_calibration(jp, tokens, jcfg, jpol), jpol)
    t_ranges = calibrate.stats_to_ranges(calibrate.run_calibration(tp, tokens, cfg, tpol),
                                         tpol, "cpu")
    prompt = tokens[:1, :12]

    def jax_run(ranges):
        sim, _, _ = j_qm.qforward(jp, {"ranges": ranges}, jnp.asarray(prompt), jcfg, jpol)
        packed = JE.pack(jp, ranges, jcfg, jpol,
                         JE.EngineConfig(model=jcfg, max_seq_len=128, weight_bits=4))
        eng, _ = JE.forward(packed, jnp.asarray(prompt), jcfg, jpol, use_pallas=False)
        return np.asarray(sim), np.asarray(eng)

    def port_run(ranges):
        with torch.no_grad():
            sim, _, _ = qmodel.qforward(tp, {"ranges": ranges}, torch.from_numpy(prompt), cfg,
                                        tpol)
        packed = E.pack(tp, ranges, cfg, tpol, E.EngineConfig(model=cfg, max_seq_len=128),
                        device="cpu")
        eng, _ = E.forward(packed, torch.from_numpy(prompt), cfg, tpol)
        return sim.numpy(), eng.numpy()

    runs = {("jax", "jax ranges"): jax_run(j_ranges),
            ("jax", "port ranges"): jax_run(jax.tree.map(jnp.asarray,
                                                         qstate_to_numpy(t_ranges))),
            ("port", "jax ranges"): port_run(from_jax_qstate(
                jax.tree.map(np.asarray, j_ranges), "cpu")),
            ("port", "port ranges"): port_run(t_ranges)}
    gap = max(rel(t_ranges[s][r][k].numpy(), np.asarray(j_ranges[s][r][k]))
              for s in j_ranges for r in j_ranges[s] for k in ("scale", "offset"))
    print(f"ranges: the largest relative gap between the packages' {gap:.3g}")
    for which in ("jax ranges", "port ranges"):
        print(f"{which}: port sim vs JAX sim {rel(runs['port', which][0], runs['jax', which][0]):.3g}"
              f", port engine vs JAX engine "
              f"{rel(runs['port', which][1], runs['jax', which][1]):.3g}")
    print(f"JAX sim on the port's ranges vs on its own: "
          f"{rel(runs['jax', 'port ranges'][0], runs['jax', 'jax ranges'][0]):.3g}")
    for (pkg, which), (sim, eng) in runs.items():
        print(f"{pkg} engine vs {pkg} sim, {which}: {rel(eng, sim):.3g}")


if __name__ == "__main__":
    main()
