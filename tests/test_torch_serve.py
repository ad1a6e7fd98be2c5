"""The port's continuous batcher (runtime/serve.py), its online server
(runtime/server.py) and chat templates (runtime/chat.py) held against the JAX
package on the CPU.

Packs: the JAX package's test-llama (calibrated W8 per-tensor asymmetric, S
32, as tests/test_runtime_extras.py's _engine_setup; the int4 cache with
kv_bits_policy) carried across with convert.from_jax_packed, and a
weight-only W4 g16 pack made by both packages from the same params. The JAX
batcher runs its XLA engine; the port's runs its kernel routes, whose
wrappers run their plain versions on CPU tensors. Greedy outputs equal the
JAX ContinuousBatcher's, request by request, and the port's sequential
Generator.generate, under every scheduling mode: bucketed and chunked
prefill, refill waves with more requests than slots (batched, padded to a
power of two), chunk_decode with adaptive and capped pipelines, speculative
tail ticks, the int4 cache and weight-only mode. The JAX batcher's greedy
outputs do not depend on its scheduling mode (its own tests hold every mode
to its sequential Generator), and each JAX batcher compiles its programs
anew, so one JAX batcher run a pack (bucketed; chunked on the int4 cache,
which requires it) is the JAX reference for every mode.
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import chat as JCHAT
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime import wonly as JW
from mobilequant_tpu.runtime.sampling import SamplerConfig as JSamplerConfig
from mobilequant_tpu.runtime.serve import ContinuousBatcher as JBatcher

from mobilequant_tpu_torch.convert import from_jax_params
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import chat as CHAT
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import serve as SV
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.sampling import SamplerConfig
from mobilequant_tpu_torch.runtime.server import InferenceServer, make_http_server

from test_torch_speculative import REPEAT, S_MAX as S, build

N_NEW = 6


def _wonly_pack():
    jcfg = j_get_config("test-llama")
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    jpacked = JW.pack_weight_only(params, jcfg, JQC(bitwidth=4, is_per_channel=True,
                                                    group_size=16, is_symmetric=False))
    cfg = get_config("test-llama")
    packed = W.pack_weight_only(from_jax_params(jax.tree.map(np.asarray, params), "cpu"), cfg,
                                QuantConfig(bitwidth=4, is_per_channel=True, group_size=16,
                                            is_symmetric=False))
    return {"j": (jcfg, None, jpacked, JE.EngineConfig(model=jcfg, max_seq_len=S, act_bits=16)),
            "t": (cfg, None, packed, E.EngineConfig(model=cfg, max_seq_len=S, act_bits=16))}


_PACKS = {"int8": lambda: build(8), "int4": lambda: build(8, 4),
          "wonly": _wonly_pack}


@pytest.fixture(scope="module")
def packs():
    cache = {}

    def get(name):
        if name not in cache:
            b = _PACKS[name]()
            cfg, pol, packed, ecfg = b["t"]
            b["gen"] = Generator(packed, cfg, pol, ecfg, device="cpu")
            b["seq"], b["jax"] = {}, {}
            cache[name] = b
        return cache[name]
    return get


def _prompts(seed, lens=(5, 9, 7, 12, 4, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _sequential(b, prompts, n=N_NEW):
    key = (tuple(map(tuple, prompts)), n)
    if key not in b["seq"]:
        b["seq"][key] = [b["gen"].generate(p[None], n)[0].tolist() for p in prompts]
    return b["seq"][key]


def _jax_reference(b, name, prompts, n=N_NEW):
    key = (tuple(map(tuple, prompts)), n)
    if key not in b["jax"]:
        kw = dict(batch_slots=2, **({"chunk_prefill": 8} if name == "int4"
                                    else {"prefill_buckets": (16, 32)}))
        b["jax"][key] = _jax(b, prompts, n, **kw)
    return b["jax"][key]


def _port(b, prompts, n=N_NEW, samplers=None, **kw):
    cfg, pol, packed, ecfg = b["t"]
    cb = SV.ContinuousBatcher(packed, cfg, pol, ecfg, device="cpu", **kw)
    rids = [cb.submit(p, n, sampler=None if samplers is None else samplers[i])
            for i, p in enumerate(prompts)]
    outs = cb.run()
    return [outs[r] for r in rids], cb


def _jax(b, prompts, n=N_NEW, **kw):
    jcfg, jpol, jpacked, jecfg = b["j"]
    if "sampler" in kw:
        kw["sampler"] = JSamplerConfig(**kw["sampler"].__dict__)
    cb = JBatcher(jpacked, jcfg, jpol, jecfg, **kw)
    rids = [cb.submit(p, n) for p in prompts]
    outs = cb.run()
    return [outs[r] for r in rids]


MODES = {
    "bucketed": ("int8", dict(batch_slots=2, prefill_buckets=(16, 32))),
    "chunked": ("int8", dict(batch_slots=2, chunk_prefill=8)),
    "waves_bucketed": ("int8", dict(batch_slots=3, prefill_buckets=(16, 32))),
    "waves_chunked": ("int8", dict(batch_slots=3, chunk_prefill=8)),
    "chunk_decode3_p0": ("int8", dict(batch_slots=2, prefill_buckets=(16,), chunk_decode=3)),
    "chunk_decode3_p2": ("int8", dict(batch_slots=2, chunk_prefill=8, chunk_decode=3,
                                      pipeline_ticks=2)),
    "spec4": ("int8", dict(batch_slots=2, prefill_buckets=(16,), spec_k=4)),
    "int4_chunked": ("int4", dict(batch_slots=2, chunk_prefill=8, chunk_decode=3)),
    "wonly": ("wonly", dict(batch_slots=2, prefill_buckets=(16,))),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_batcher_matches_jax_and_sequential(packs, mode, monkeypatch):
    name, kw = MODES[mode]
    b = packs(name)
    prompts = _prompts(3)
    groups = []
    orig = SV.ContinuousBatcher._prefill_group
    monkeypatch.setattr(SV.ContinuousBatcher, "_prefill_group",
                        lambda self, grp, key: groups.append(len(grp)) or orig(self, grp, key))
    got, cb = _port(b, prompts, **kw)
    assert got == _sequential(b, prompts), mode
    assert got == _jax_reference(b, name, prompts), mode
    assert cb.stats["tokens_out"] == N_NEW * len(prompts)
    if mode.startswith("waves"):
        assert groups and max(groups) > 1          # a batched refill wave ran
    if mode.startswith("chunk_decode") or mode == "int4_chunked":
        # chunked ticks: one read-back a tick and one a refill wave
        assert cb.stats["ticks"] < N_NEW * len(prompts) // 2
    assert cb.stats["host_syncs"] <= cb.stats["ticks"] + len(prompts)


def test_speculative_tail_ticks(packs, monkeypatch):
    """spec_k: a lone live greedy request runs prompt-lookup rounds on a copy
    of its slot's rows; the stream equals the Generator's and the JAX
    batcher's; EOS truncates; two live requests keep the regular ticks."""
    b = packs("int8")
    prompt = REPEAT[0]
    calls = [0]
    orig = SV.spec_round

    def spy(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(SV, "spec_round", spy)
    want = _sequential(b, [prompt], 14)[0]
    got, cb = _port(b, [prompt], 14, batch_slots=2, prefill_buckets=(16,), spec_k=4)
    assert calls[0] > 0 and got[0] == want
    assert got[0] == _jax_reference(b, "int8", [prompt], 14)[0]
    assert cb.stats["host_syncs"] < 14           # rounds read back once a wave
    eos = want[5]
    got_eos, _ = _port(b, [prompt], 14, batch_slots=2, prefill_buckets=(16,), spec_k=4,
                       eos_token_id=eos)
    assert got_eos[0] == want[:want.index(eos) + 1]
    calls[0] = 0
    both, _ = _port(b, [prompt, prompt[:7]], 6, batch_slots=2, prefill_buckets=(16,),
                    spec_k=4)
    assert [len(o) for o in both] == [6, 6]


def test_mixed_samplers_keep_greedy_exact_and_repeat(packs):
    """Per-request samplers under a hot default: greedy requests equal the
    sequential greedy streams beside hot, top-k and top-p neighbours, on
    single-token ticks and on chunked per-slot-temperature ticks (fewer
    ticks); a second run with the same seed repeats every stream."""
    b = packs("int8")
    prompts = _prompts(11, (5, 9, 7, 6, 8))
    greedy = SamplerConfig(greedy=True)
    samplers = [greedy, SamplerConfig(temperature=0.8), greedy,
                SamplerConfig(temperature=1.0, top_k=40, top_p=0.9), greedy]
    seq = _sequential(b, prompts)
    ticks = {}
    for cd in (1, 3):
        runs = []
        for _ in range(2):
            got, cb = _port(b, prompts, samplers=samplers, batch_slots=3,
                            prefill_buckets=(16,), sampler=SamplerConfig(temperature=1.5),
                            chunk_decode=cd, seed=5)
            runs.append(got)
            ticks[cd] = cb.stats["ticks"]
        assert runs[0] == runs[1]
        for i in (0, 2, 4):
            assert runs[0][i] == seq[i], (cd, i)
        assert all(len(o) == N_NEW for o in runs[0])
    # plain-temperature mixes ride chunked ticks: greedy + hot only
    hot = [greedy, SamplerConfig(temperature=0.8), greedy, greedy, SamplerConfig(temperature=1.2)]
    got, cb = _port(b, prompts, samplers=hot, batch_slots=3, prefill_buckets=(16,),
                    sampler=SamplerConfig(temperature=1.5), chunk_decode=3, seed=5)
    assert [got[i] for i in (0, 2, 3)] == [seq[i] for i in (0, 2, 3)]
    assert cb.stats["ticks"] < ticks[1]


def test_batcher_refuses(packs):
    b = packs("int8")
    cfg, pol, packed, ecfg = b["t"]
    with pytest.raises(NotImplementedError, match="mesh"):
        SV.ContinuousBatcher(packed, cfg, pol, ecfg, mesh=object(), device="cpu")
    b4 = packs("int4")
    cfg, pol4, packed4, ecfg4 = b4["t"]
    with pytest.raises(ValueError, match="chunk_prefill"):
        SV.ContinuousBatcher(packed4, cfg, pol4, ecfg4, device="cpu")
    with pytest.raises(ValueError, match="KV bitwidth"):
        SV.ContinuousBatcher(packed, cfg, pol4, ecfg, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        SV.ContinuousBatcher(packed, cfg, pol, ecfg, chunk_prefill=24, device="cpu")


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _http(cb):
    """An InferenceServer over `cb` behind the HTTP front end on an ephemeral
    loopback port -> (server, port); both are shut down after."""
    srv = InferenceServer(cb).start()
    httpd = make_http_server(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_http_server_matches_generator(packs):
    """Live requests from client threads through the HTTP front end equal the
    Generator's greedy streams; an oversized prompt gets a 400 and the server
    goes on serving; per-request sampler fields pass through (a greedy
    request under a hot default); /health and /stats answer."""
    b = packs("int8")
    cfg, pol, packed, ecfg = b["t"]
    prompts = _prompts(7, (5, 9, 3, 11))
    refs = _sequential(b, prompts)
    cb = SV.ContinuousBatcher(packed, cfg, pol, ecfg, batch_slots=2, prefill_buckets=(16,),
                              sampler=SamplerConfig(temperature=1.5), device="cpu")
    with _http(cb) as (srv, port):
        results = [None] * len(prompts)

        def post(i):
            results[i] = _post(port, {"prompt_ids": [int(x) for x in prompts[i]],
                                      "max_new_tokens": N_NEW, "temperature": 0.0})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        code, body = _post(port, {"prompt_ids": list(range(40)), "max_new_tokens": 4})
        assert code == 400 and "exceeds the serving limit" in body["error"]
        for th in threads:
            th.join(timeout=180)
        for (code, body), ref in zip(results, refs):
            assert code == 200 and body["completion_ids"] == ref
        code, body = _post(port, {"prompt_ids": [int(x) for x in prompts[0]],
                                  "max_new_tokens": N_NEW, "greedy": True})
        assert code == 200 and body["completion_ids"] == refs[0]
        code, hot = _post(port, {"prompt_ids": [int(x) for x in prompts[0]],
                                 "max_new_tokens": N_NEW})
        assert code == 200 and len(hot["completion_ids"]) == N_NEW
        assert _post(port, {"prompt": "hi"})[0] == 400          # no tokenizer
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            st = json.loads(r.read())
            assert st["active"] == 0 and st["host_syncs"] > 0
        with pytest.raises(ValueError, match="exceeds the serving limit"):
            srv.generate(np.arange(40), 4, timeout=60)
        assert srv.generate(prompts[1], N_NEW, timeout=120,
                            sampler=SamplerConfig(greedy=True)) == refs[1]


def test_prompt_at_cache_length_is_refused(packs):
    """A prompt of max_seq_len tokens leaves its first decode step no cache
    row to write: the batcher refuses it, bucketed (its largest bucket is the
    cache's length) and chunked, and refuses an empty prompt; a prompt of
    max_seq_len - 1 tokens serves to the cache's end (two tokens), equal to
    the Generator's. Over HTTP the refused prompt gets a 400 and the server
    goes on serving."""
    b = packs("int8")
    cfg, pol, packed, ecfg = b["t"]
    full, edge, short = _prompts(11, (S, S - 1, 6))
    ref = b["gen"].generate(edge[None], 2)[0].tolist()
    for kw in (dict(prefill_buckets=(16, 32)), dict(chunk_prefill=8)):
        cb = SV.ContinuousBatcher(packed, cfg, pol, ecfg, batch_slots=2, device="cpu", **kw)
        assert cb.max_prompt_len == S - 1
        with pytest.raises(ValueError, match="exceeds the serving limit"):
            cb.submit(full, N_NEW)
        with pytest.raises(ValueError, match="empty"):
            cb.submit([], N_NEW)
        rid = cb.submit(edge, N_NEW)
        assert cb.run()[rid] == ref, kw
    cb = SV.ContinuousBatcher(packed, cfg, pol, ecfg, batch_slots=2, prefill_buckets=(16, 32),
                              device="cpu")
    with _http(cb) as (srv, port):
        code, body = _post(port, {"prompt_ids": [int(x) for x in full], "max_new_tokens": 4})
        assert code == 400 and f"exceeds the serving limit {S - 1}" in body["error"]
        for p, want in ((edge, ref), (short, _sequential(b, [short])[0])):
            code, body = _post(port, {"prompt_ids": [int(x) for x in p],
                                      "max_new_tokens": N_NEW})
            assert code == 200 and body["completion_ids"] == want


class _ToyTokenizer:
    """One id per character (ord % 200), the special pieces at 200 + i."""

    def __init__(self):
        specials = sorted({t for segs in CHAT.TEMPLATE_SEGMENTS.values()
                           for kind, t in segs if kind == "special"})
        self.special = {t: 200 + i for i, t in enumerate(specials)}

    def encode(self, text, prefix=()):
        return list(prefix) + [ord(c) % 200 for c in text]

    def piece_to_id(self, piece):
        return self.special.get(piece, -1)


def test_chat_templates_match_jax():
    assert CHAT.CHAT_TEMPLATES == JCHAT.CHAT_TEMPLATES
    assert CHAT.TEMPLATE_SEGMENTS == JCHAT.TEMPLATE_SEGMENTS
    tok = _ToyTokenizer()
    for fam in CHAT.CHAT_TEMPLATES:
        assert CHAT.apply_chat_template("hi there", fam) == \
            JCHAT.apply_chat_template("hi there", fam)
        ids = tok.encode("hello")
        assert CHAT.apply_chat_template_ids(ids, fam, tok.encode, tok.piece_to_id) == \
            JCHAT.apply_chat_template_ids(ids, fam, tok.encode, tok.piece_to_id)
        assert CHAT.apply_chat_template_ids(ids, fam, tok.encode, lambda _: -1) == \
            JCHAT.apply_chat_template_ids(ids, fam, tok.encode, lambda _: -1)
    with pytest.raises(KeyError):
        CHAT.apply_chat_template("hi", "mistralx")
