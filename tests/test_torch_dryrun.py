"""The port's launch dry run against the JAX package's: ``models.costs``'s
``attention_flops`` / ``model_flops``, ``launch.roofline``'s
``roofline_terms`` and collective model, the counted step of
``launch.roofline.analyze_step`` (on the meta device) and
``launch.dryrun``'s records, at smoke sizes.

Tolerances: the analytic FLOP counts rel 1e-12 (the same arithmetic);
the roofline terms and collective bytes exactly; a counted prefill's
matrix products rel 1e-9 of the reference's compiled HLO once each side's
attention is taken out, since the two count attention differently by
design -- the reference's flash computes every pair of whole 512-slot kv
chunks (padded slots too), the port bills the tiles the card's kernel
computes (``kernels.flash_attention.kernel_flops``).
"""
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.models import costs as jcosts
from repro.serve import cache as JC, engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun as TD, mesh as TMESH
from repro_torch.launch import roofline as TR, specs as TS
from repro_torch.models import costs as tcosts, layers as TL, model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.serve import cache as TC
from repro_torch.train import step as TT

CELLS = tconfigs.all_cells()
META = torch.device("meta")
ONE = {"data": 1, "model": 1}
# the production shapes cut to smoke lengths (names kept): a rank's batch
# block and microbatches as the production mesh gives them
SMOKE_SHAPES = {
    "train_4k": tconfigs.Shape("train_4k", 64, 256, "train"),
    "prefill_32k": tconfigs.Shape("prefill_32k", 96, 32, "prefill"),
    "decode_32k": tconfigs.Shape("decode_32k", 96, 128, "decode"),
    "long_500k": tconfigs.Shape("long_500k", 160, 1, "decode"),
}


@pytest.fixture(scope="module", autouse=True)
def cached_reference_breakdown():
    """The reference's ``param_breakdown`` traces ``init_model`` with
    ``jax.eval_shape`` at every call: once a config here."""
    cached = functools.lru_cache(maxsize=None)(jcosts.param_breakdown)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcosts, "param_breakdown", cached)
        yield


# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------

def test_cells_match_reference():
    assert CELLS == jconfigs.all_cells()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    got = tcosts.model_flops(tconfigs.get(arch), tconfigs.SHAPES[shape])
    want = jcosts.model_flops(jconfigs.get(arch), jconfigs.SHAPES[shape])
    assert got["params"] == want["params"]
    assert got["total_flops"] == pytest.approx(want["total_flops"],
                                               rel=1e-12)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_attention_flops_match_reference(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    assert tcosts._attention_layers(tcfg) == jcosts._attention_layers(jcfg)
    for s_q, s_kv in ((1, 32768), (4096, 4096), (32768, 32768),
                      (1, 524288), (7, 100)):
        for causal_avg in (False, True):
            assert tcosts.attention_flops(tcfg, s_q, s_kv, causal_avg) == \
                pytest.approx(jcosts.attention_flops(jcfg, s_q, s_kv,
                                                     causal_avg), rel=1e-12)


# ---------------------------------------------------------------------------
# the roofline and the collective model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,n_bytes,wire", [
    (1e15, 1e9, 1e8), (1e12, 5e12, 1e8), (1e12, 1e9, 5e11), (0.0, 0.0, 0.0),
    (989e12, 3.35e12, 450e9)])
def test_roofline_terms_match_reference(flops, n_bytes, wire):
    kw = dict(peak_flops=TMESH.PEAK_FLOPS_BF16, hbm_bw=TMESH.HBM_BW,
              ici_bw=TMESH.ICI_BW)
    assert TR.roofline_terms(flops, n_bytes, wire, **kw) == \
        JR.roofline_terms(flops, n_bytes, wire, **kw)


def _hlo(opcode: str, g: int) -> str:
    """A module of one ``opcode`` over a group of ``g`` devices, f32."""
    shapes = {"all-gather": ("f32[16,8]", f"f32[{16 * g},8]"),
              "reduce-scatter": (f"f32[{16 * g},8]", "f32[16,8]")}
    arg, res = shapes.get(opcode, ("f32[16,8]", "f32[16,8]"))
    extra = {"all-gather": ", dimensions={0}",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-reduce": ", to_apply=%add",
             "all-to-all": ", dimensions={0}",
             "collective-permute": ", source_target_pairs={{0,1},{1,0}}"}
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    return f"""HloModule m

%add (a: f32[], b: f32[]) -> f32[] {{
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}}

ENTRY %main (p0: {arg}) -> {res} {{
  %p0 = {arg}{{1,0}} parameter(0)
  ROOT %c = {res}{{1,0}} {opcode}({arg}{{1,0}} %p0), replica_groups={groups}{extra[opcode]}
}}
"""


@pytest.mark.parametrize("opcode", TR.COLLECTIVES)
@pytest.mark.parametrize("g", (2, 4, 16))
def test_collective_bytes_match_reference_hlo(opcode, g):
    """One collective of each kind in hand-written HLO, through the
    reference's parser, against ``collective_bytes`` and
    ``StepAnalysis.add_collective``."""
    want = JR.analyze_hlo(_hlo(opcode, g), g)
    assert want.n_collective_ops == 1
    res_bytes = 16 * 8 * 4 * (g if opcode == "all-gather" else 1)
    wire, operand = TR.collective_bytes(opcode, res_bytes, g)
    assert (wire, operand) == (want.collective_wire_bytes,
                               want.collective_operand_bytes)
    got = TR.StepAnalysis()
    got.add_collective(opcode, res_bytes, g)
    merged, ref = got.merged(), want.merged()
    for key in ("collective_wire_bytes", "collective_operand_bytes",
                "per_collective", "per_group_size", "n_collective_ops"):
        assert merged[key] == ref[key], key


# ---------------------------------------------------------------------------
# the counted step
# ---------------------------------------------------------------------------

def test_analyze_step_counts_products_bytes_and_peak():
    a = torch.empty(64, 32, device=META)
    w = torch.empty(32, 16, device=META)

    def step():
        h = a @ w                       # 64 x 16 float32: 4096 B
        g = h.relu()                    # 4096 B more, h still live
        del h                           # freed
        return (g * 2).sum()            # g, g * 2 and the sum live

    rec = TR.analyze_step(step)
    assert rec.dot_flops == 2 * 64 * 32 * 16
    assert rec.peak_live_bytes == 2 * 4096 + 4
    # mm writes 4096 B, relu 4096, mul 4096, sum 4; reads a, w, h, g, g*2
    assert rec.bytes_written == 3 * 4096 + 4
    assert rec.bytes_read == 8192 + 2048 + 3 * 4096
    assert rec.output_bytes == 4 and rec.alias_bytes == 0


def test_analyze_step_tracks_host_values_through_a_ring_write():
    """Positions made by ``arange`` on meta, written into a ring's slots,
    carry their values: the attention's count reads them."""
    pos_ids = torch.full((8,), -1, dtype=torch.int32, device=META)
    seen = {}

    def step():
        pos = torch.arange(0, 11, dtype=torch.int32, device=META)
        slots = (pos % 8).long()
        pos_ids[slots] = pos
        seen["ring"] = fa.META_TRACE.positions(pos_ids).tolist()

    rec = TR.analyze_step(step, known={pos_ids: np.full(8, -1)})
    assert seen["ring"] == [8, 9, 10, 3, 4, 5, 6, 7]
    assert rec.dot_flops == 0


def test_ring_write_past_the_ring_keeps_each_slots_latest_position():
    """A prompt eight times a ring's length written in one indexed write:
    every slot keeps its last position on every run (the host's threaded
    write would keep any of the eight)."""
    smax, n = 4096, 32768
    for _ in range(3):
        pos_ids = torch.full((smax,), -1, dtype=torch.int32, device=META)
        seen = {}

        def step():
            pos = torch.arange(0, n, dtype=torch.int32, device=META)
            pos_ids[(pos % smax).long()] = pos
            seen["ring"] = fa.META_TRACE.positions(pos_ids)

        TR.analyze_step(step, known={pos_ids: np.full(smax, -1)})
        assert torch.equal(seen["ring"],
                           torch.arange(n - smax, n, dtype=torch.int32))


def _brute_kernel_flops(kernel, B, H, KH, D, Dv, qp, kp, causal, window):
    """The kernel's tiles counted one by one from its own rules."""
    G, Sq, Skv = H // KH, len(qp), len(kp)

    def ok(q, p):
        if p < 0:
            return False
        if not causal:
            return True
        return 0 <= q - p and (window is None or q - p < window)

    def tile_live(rows, s0, width):
        qs = [qp[r // G] for r in rows]
        lo, hi = min(qs), max(qs)
        for s in range(s0, min(s0 + width, Skv)):
            p = kp[s]
            if p >= 0 and (not causal or (p <= hi and (
                    window is None or p > lo - window))):
                return True
        return False

    if kernel == "split_kv":
        rows = Sq * G
        live = sum(any(ok(qp[r // G], kp[s]) for r in range(rows)
                       for s in range(c, min(c + 64, Skv)))
                   for c in range(0, Skv, 64))
        return 2.0 * B * KH * live * rows * 64 * (D + Dv)
    if kernel == "wgmma":
        gb = min(G, 128)
        per = 128 // gb
        heads = -(-G // gb)
        live = 0
        for p0 in range(0, Sq, per):
            rows = [i * G for i in range(p0, min(p0 + per, Sq))]
            live += sum(tile_live(rows, s0, 64) for s0 in range(0, Skv, 64))
        dims = 64 * (-(-D // 64) + -(-Dv // 64))
        return 2.0 * B * KH * heads * live * 128 * 64 * dims
    live = 0
    for r0 in range(0, Sq * G, 64):
        rows = list(range(r0, min(r0 + 64, Sq * G)))
        live += sum(tile_live(rows, s0, 64) for s0 in range(0, Skv, 64))
    return 2.0 * B * KH * live * 64 * 64 * (D + Dv)


def _ring(smax, n):
    return [j + smax * ((n - 1 - j) // smax) if j < n else -1
            for j in range(smax)]


ATTN_CASES = [
    # kernel, dtype, B, H, KH, D, Dv, q positions, kv positions, causal,
    # window
    ("wgmma", torch.bfloat16, 2, 8, 2, 128, 128, list(range(300)),
     list(range(300)), True, None),
    ("wgmma", torch.bfloat16, 1, 4, 1, 120, 120, list(range(200)),
     list(range(200)) + [-1] * 40, True, 64),
    ("wgmma", torch.bfloat16, 1, 4, 4, 192, 128, list(range(130)),
     list(range(130)), True, None),
    ("wgmma", torch.bfloat16, 2, 4, 4, 64, 64, [0] * 50, list(range(150)),
     False, None),
    ("split_kv", torch.bfloat16, 4, 8, 2, 128, 128, [300],
     _ring(256, 300), True, 256),
    ("split_kv", torch.bfloat16, 2, 8, 1, 64, 64, [99], list(range(99))
     + [-1] * 60, True, None),
    ("simt", torch.float32, 1, 4, 2, 32, 32, list(range(150)),
     list(range(150)), True, 40),
    ("simt", torch.float32, 2, 2, 1, 48, 48, list(range(70, 100)),
     _ring(64, 100), True, 64),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ATTN_CASES)])
def test_meta_attention_bills_the_kernels_tiles(case):
    kernel, dtype, B, H, KH, D, Dv, qp, kp, causal, window = case
    q = torch.empty(B, len(qp), H, D, dtype=dtype, device=META)
    k = torch.empty(B, len(kp), KH, D, dtype=dtype, device=META)
    v = torch.empty(B, len(kp), KH, Dv, dtype=dtype, device=META)
    qpos = torch.empty(len(qp), dtype=torch.int32, device=META)
    kpos = torch.empty(len(kp), dtype=torch.int32, device=META)
    out = {}

    def step():
        out["o"] = fa.attend(q, k, v, qpos, kpos, causal=causal,
                             window=window)

    rec = TR.analyze_step(step, known={qpos: qp, kpos: kp})
    assert fa.choose_kernel(dtype, D, Dv, len(qp) * (H // KH)) == kernel
    want = _brute_kernel_flops(kernel, B, H, KH, D, Dv, qp, kp, causal,
                               window)
    assert rec.kernel_calls == {f"flash_attention_{kernel}": 1}
    assert rec.kernel_flops[f"flash_attention_{kernel}"] == want
    assert rec.dot_flops == want
    assert fa.kernel_flops(kernel, B, H, KH, D, Dv, np.array(qp),
                           np.array(kp), causal, window) == want
    o = out["o"]
    assert o.shape == (B, len(qp), H, Dv) and o.dtype == dtype and o.is_meta
    n_read = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + 4 * (len(qp) + len(kp))
    assert rec.bytes_read == n_read
    assert rec.bytes_written == o.numel() * o.element_size()


def test_meta_attention_needs_the_dry_runs_tracer():
    q = torch.empty(1, 4, 2, 32, dtype=torch.bfloat16, device=META)
    pos = torch.empty(4, dtype=torch.int32, device=META)
    with pytest.raises(RuntimeError, match="meta"):
        fa.attend(q, q, q, pos, pos)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_live_row_bounds_match_the_masks(causal, window):
    """The backward's row bounds from host positions (the meta path) equal
    the ones its masks give (the device path)."""
    rng = np.random.default_rng(3)
    G, chunk = 3, 16
    qp = np.sort(rng.choice(200, 40, replace=False)).astype(np.int32)
    kp = np.array(_ring(64, 150), dtype=np.int32)
    kp[rng.choice(64, 6, replace=False)] = -1
    chunks = [(c, min(c + chunk, kp.size)) for c in range(0, kp.size, chunk)]
    got = fa.live_row_bounds(qp, kp, chunks, G, causal, window)
    q_rows = torch.as_tensor(qp).repeat_interleave(G)
    R = q_rows.numel()
    want = []
    for c0, c1 in chunks:
        mk = fa._mask(q_rows, torch.as_tensor(kp[c0:c1]), causal,
                      window)[0, :, 0, 0]
        live = mk.any(1).int()
        want.append([int(live.amax()), int(live.argmax()),
                     R - int(live.flip(0).argmax())])
    assert got == want


@pytest.fixture(scope="module")
def smoke_train():
    cfg = tconfigs.get_smoke("qwen3-4b")
    return cfg, tconfigs.Shape("train_4k", 48, 4, "train")


def test_meta_train_step_runs_its_backward_with_no_host_read(smoke_train):
    """The rank's train step on meta: the attention's forward on the wgmma
    kernel (forward and remat's recompute), its backward in plain torch
    with the row bounds from the positions' host values."""
    cfg, shape = smoke_train
    rec = TD.run_cell("qwen3-4b", shape, cfg=cfg, mesh=ONE, accum=2,
                      verbose=False)
    calls = rec["counted"]["kernel_calls"]
    assert calls == {"flash_attention_wgmma": 2 * 2 * cfg.n_layers}
    assert rec["counted"]["dot_flops"] > rec["model_flops"]["total_flops"]


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", tconfigs.Shape("train", 48, 4, "train")),
    ("gemma2-27b", tconfigs.Shape("prefill", 80, 2, "prefill")),
    ("xlstm-1.3b", tconfigs.Shape("train", 16, 2, "train")),
])
def test_layout_cache_counts_what_running_every_op_counts(monkeypatch, arch,
                                                          shape):
    """The tracer's cache of fresh output layouts changes no count: the
    same record as running every op's meta kernel, peaks included (an op
    whose schema claims a fresh output but returns its input's storage,
    ``_unsafe_view``, must not count twice)."""
    cfg = tconfigs.get_smoke(arch)

    def record():
        rec = TD.run_cell(arch, shape, cfg=cfg, mesh=ONE, verbose=False)
        return rec["counted"], rec["memory"]

    cached = record()

    def run_every_op(self, func, args, kwargs, leaves):
        if func._overloadpacket in self.products:
            return func(*args, **kwargs)
        with TR._disable_current_modes():
            return func(*args, **kwargs)

    monkeypatch.setattr(TR._Tracer, "_run", run_every_op)
    assert record() == cached


def test_rank_step_on_one_device_is_the_single_device_step(smoke_train):
    """On a (1, 1) mesh the rank's step counts what ``make_train_step``'s
    own step counts, traced on a meta state: the same products and peak,
    the bytes within 1e-6 (the rank's step scales its gradients in place,
    the plain step's loss scale is one scalar op more)."""
    cfg, shape = smoke_train
    rec = TD.run_cell("qwen3-4b", shape, cfg=cfg, mesh=ONE, accum=2,
                      verbose=False)
    state, _ = TS.train_state_specs(cfg)
    batch = TS.token_specs(cfg, shape.global_batch, shape.seq_len,
                           with_labels=True)
    step = TT.make_train_step(cfg, adamw.AdamWConfig(), accum=2)
    plain = TR.analyze_step(lambda: step(state, batch)[1]["loss"])
    counted = rec["counted"]
    assert counted["dot_flops"] == plain.dot_flops
    assert counted["kernel_flops"] == plain.kernel_flops
    assert counted["peak_live_bytes"] == plain.peak_live_bytes
    assert counted["bytes_accessed"] == pytest.approx(
        plain.bytes_accessed, rel=1e-6)


def test_prefill_products_match_reference_hlo():
    """A smoke qwen3-4b prefill on one device: the port's counted matrix
    products equal the reference's compiled dots once each side's
    attention is taken out (module docstring); the port's attention is
    the wgmma kernel's tiles."""
    B, S = 2, 40
    tcfg, jcfg = tconfigs.get_smoke("qwen3-4b"), jconfigs.get_smoke(
        "qwen3-4b")
    rec = TD.run_cell("qwen3-4b", tconfigs.Shape("prefill", S, B,
                                                 "prefill"),
                      cfg=tcfg, mesh=ONE, verbose=False)["counted"]
    params, _, batch, _, tree = JS.serve_specs(jcfg, B, S, "prefill")
    hlo = jax.jit(lambda p, b, c: jengine.prefill(p, jcfg, b, c)).lower(
        params, batch, JC.sds(tree)).compile().as_text()
    ref = JR.analyze_hlo(hlo, 1).dot_flops
    H, KH, Dh, L = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, \
        tcfg.n_layers
    chunks = math.ceil(S / 512) * 512
    ref_attention = L * 4.0 * B * S * chunks * H * Dh
    kernel = L * fa.kernel_flops("wgmma", B, H, KH, Dh, Dh, np.arange(S),
                                 np.arange(S))
    assert rec["kernel_flops"] == {"flash_attention_wgmma": kernel}
    assert rec["dot_flops"] - kernel == pytest.approx(ref - ref_attention,
                                                      rel=1e-9)


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

# the reference's record keys, renamed as launch/dryrun.py says
RECORD_KEYS = {"arch", "shape", "mesh", "accum", "trace_s", "counted",
               "model_flops", "useful_flops_ratio", "roofline",
               "memory", "batch_per_device", "cache_sharded",
               "serving_pattern"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "alias_bytes",
               "temp_bytes", "peak_per_device_bytes", "fits_card",
               "card_bytes", "cache_bytes"}


def _expected_argument_bytes(cfg, shape, sizes) -> int:
    """The rank's blocks of every leaf (``logical_spec`` over the sizes),
    12 B a master element (the master and both moments) or its serving
    dtype's bytes, plus the batch block and the rank's blocks of the cache
    (``serve.cache.held_spec``)."""
    rows = shape.global_batch // math.prod(
        sizes[a] for a in sh.entry_axes(sh.logical_spec(
            ("batch",), (shape.global_batch,), sizes)[0]))
    train = shape.kind == "train"
    model = TM.init_model(cfg, device="meta", trainable=train)
    total = 0
    for name, p in model.named_parameters():
        spec = sh.logical_spec(model.axes[name], p.shape, sizes)
        block = math.prod(n // math.prod(sizes[a] for a in sh.entry_axes(e))
                          for n, e in zip(p.shape, spec))
        total += block * (12 if train else p.element_size())
    kind = "prefill" if train else shape.kind
    _, _, batch, _, spec = TS.serve_specs(cfg, rows, shape.seq_len, kind)
    if train:
        batch = TS.token_specs(cfg, rows, shape.seq_len, with_labels=True)
    else:
        spec = TS.serve_specs(cfg, shape.global_batch, shape.seq_len,
                              kind)[4]
        for leaf in TC.leaves(spec):
            held = TC.held_spec(leaf, sizes)
            total += math.prod(
                n // math.prod(sizes[a] for a in sh.entry_axes(e))
                for n, e in zip(leaf.shape, held)) * leaf.dtype.itemsize
    return total + sum(t.numel() * t.element_size() for t in batch.values())


@pytest.mark.parametrize("multi_pod", (False, True),
                         ids=("singlepod", "multipod"))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_record(arch, shape, multi_pod):
    cfg = tconfigs.get_smoke(arch)
    sh_ = SMOKE_SHAPES[shape]
    rec = TD.run_cell(arch, sh_, cfg=cfg, multi_pod=multi_pod,
                      verbose=False)
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(JR.HLOAnalysis().merged()) <= set(rec["counted"])
    sizes = TMESH.production_mesh_shape(multi_pod=multi_pod)
    assert rec["mesh"] == dict(shape=list(sizes.values()), axes=list(sizes),
                               n_devices=math.prod(sizes.values()))
    mem = rec["memory"]
    assert mem["argument_bytes"] == _expected_argument_bytes(cfg, sh_,
                                                             sizes)
    assert mem["peak_per_device_bytes"] == mem["argument_bytes"] \
        + mem["temp_bytes"]
    assert mem["fits_card"]
    # a serving cell is the rank's tensor-parallel serving step: the
    # leaves the model axis splits for the compute read as the rank's
    # blocks, the others gathered where read, its cache split along batch
    # (and kv_seq where the model axis divides it)
    split = sh_.kind != "train" and any(
        any(e is not None for e in TC.held_spec(leaf, sizes))
        for leaf in TC.leaves(TS.serve_specs(cfg, sh_.global_batch,
                                             sh_.seq_len, sh_.kind)[4]))
    assert rec["cache_sharded"] == split
    assert rec["serving_pattern"] == (None if sh_.kind == "train"
                                      else "tensor_parallel")
    counted = rec["counted"]
    assert counted["dot_flops"] > 0 and counted["collective_wire_bytes"] > 0
    dp = sizes.get("pod", 1) * sizes["data"]
    if sh_.kind == "train":
        assert rec["accum"] == min(8, sh_.global_batch // dp)
        assert counted["per_collective"].keys() >= {"all-gather",
                                                    "reduce-scatter"}
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    assert 0 < rec["useful_flops_ratio"] < 1
    # training: the "model" axis shards memory, not compute (a rank
    # computes the whole model on its batch block).  Serving splits the
    # compute: a prefill of a model without experts whose attention or
    # MLP the model axis splits (the smoke configs' 4 heads take the
    # query-row fallback on 16 ranks) counts fewer dot FLOPs than the
    # whole model on its batch block (model FLOPs / (pod x data)), so the
    # ratio exceeds 1 / model.  Not so for a decode's attention over a
    # long cache, whole where 16 does not divide the heads, nor for an
    # MoE, whose counted expert work exceeds the model's FLOPs.
    if sh_.kind == "prefill" and not cfg.moe and any(
            not n.startswith("top.")
            for n in TM.tp_leaves(cfg, sizes["model"])):
        assert rec["useful_flops_ratio"] * sizes["model"] > 1


def test_main_writes_the_record_and_the_ok_line(tmp_path, capsys):
    rc = TD.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                  "--out-dir", str(tmp_path)])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("OK   qwen3-4b") and "singlepod" in line
    rec = json.loads((tmp_path / "qwen3-4b_decode_32k_singlepod.json")
                     .read_text())
    assert rec["arch"] == "qwen3-4b" and rec["shape"] == "decode_32k"
    assert rec["counted"]["kernel_calls"] == {
        "flash_attention_split_kv": 36}
    assert rec["memory"]["fits_card"]


def test_serving_decode_bills_the_combine_all_gather():
    """A tensor-parallel decode step whose cache the model axis splits
    bills, beside what the prefill bills (the weights' all-gathers read
    for read, the logits' all-gather along the vocabulary), per layer the
    query heads' all-gather (the rank's H / 2 heads of q [B, 1, H / 2,
    Dh] in bf16; the smoke config's single kv head is whole) and one
    (out, lse) all-gather over the model ranks: out [B, 1, H * Dh] in
    bf16 and lse [B, 1, H] float32 a rank, packed, gathered from 2.  Both
    steps all-reduce the embedding and each layer's attention and MLP
    outputs, [B, S, D] in bf16."""
    cfg = tconfigs.get_smoke("qwen3-4b")
    mesh = {"data": 1, "model": 2}
    S = 96
    recs = {kind: TD.run_cell("qwen3-4b", tconfigs.Shape(kind, S, 2, kind),
                              cfg=cfg, mesh=mesh, verbose=False)
            for kind in ("prefill", "decode")}
    assert all(r["cache_sharded"] for r in recs.values())
    wire = {k: r["counted"]["per_collective"] for k, r in recs.items()}
    B, H, Dh, L = 2, cfg.n_heads, cfg.head_dim, cfg.n_layers
    gathered = lambda n_bytes: TR.collective_bytes("all-gather", n_bytes,
                                                   2)[0]
    combine = gathered(2 * B * (H * Dh * 2 + H * 4))
    q_heads = gathered(2 * B * H // 2 * Dh * 2)
    assert wire["decode"]["all-gather"] - wire["prefill"]["all-gather"] \
        == pytest.approx(L * (combine + q_heads))
    reduced = lambda s: (2 * L + 1) * TR.collective_bytes(
        "all-reduce", B * s * cfg.d_model * 2, 2)[0]
    assert wire["prefill"]["all-reduce"] == pytest.approx(reduced(S))
    assert wire["decode"]["all-reduce"] == pytest.approx(reduced(1))
    assert recs["decode"]["counted"]["kernel_calls"] == {
        "flash_attention_split_kv": cfg.n_layers}


def test_serving_prefill_splits_dot_flops_over_the_model_axis():
    """Smoke qwen3-4b's prefill (B 2, S 128) on a model axis of 2 counts
    at most 0.55 of the dot FLOPs it counts on one rank (the heads, the
    ffn columns and the vocabulary halved; its single kv head keeps wk /
    wv whole on both ranks, ~0.53 expected); S 128 keeps the attention
    kernel's 128-row tiles whole at both sizes.  The model axis gathers
    only the leaves whose split does not fall on whole heads (wk / wv,
    a layer's read each) and the logits along the vocabulary: no leaf
    the compute splits."""
    cfg = tconfigs.get_smoke("qwen3-4b")
    B, S, L = 2, 128, cfg.n_layers
    shape = tconfigs.Shape("prefill", S, B, "prefill")
    recs = {m: TD.run_cell("qwen3-4b", shape, cfg=cfg, verbose=False,
                           mesh={"data": 1, "model": m}) for m in (1, 2)}
    flops = {m: r["counted"]["dot_flops"] for m, r in recs.items()}
    assert flops[2] <= 0.55 * flops[1]
    assert recs[1]["serving_pattern"] == "whole"
    assert recs[2]["serving_pattern"] == "tensor_parallel"
    gathered = lambda n_bytes: TR.collective_bytes("all-gather", n_bytes,
                                                   2)[0]
    kv_leaf = cfg.d_model * cfg.n_kv_heads * cfg.head_dim * 2
    logits = 2 * B * cfg.vocab // 2 * 4
    assert recs[2]["counted"]["per_collective"]["all-gather"] == \
        pytest.approx(2 * L * gathered(kv_leaf) + gathered(logits))


def test_serving_moe_on_a_split_batch_bills_the_routing_all_gather():
    """Below the expert-parallel threshold an MoE layer on a batch the
    data axis splits all-gathers its routing (each token's top-k expert
    indices, int64) over the data ranks, once a layer: the prefill's
    [B / 2 * S, K] a rank against the decode's [B / 2, K], the weights'
    gathers equal read for read."""
    cfg = tconfigs.get_smoke("deepseek-v2-236b")
    mesh = {"data": 2, "model": 1}
    S, B = 96, 2
    recs = {kind: TD.run_cell("deepseek-v2-236b",
                              tconfigs.Shape(kind, S, B, kind), cfg=cfg,
                              mesh=mesh, verbose=False)
            for kind in ("prefill", "decode")}
    wire = {k: r["counted"]["per_collective"]["all-gather"]
            for k, r in recs.items()}
    n_moe = sum(grp.repeats * grp.kinds.count("mla_moe")
                for grp in TM.layer_plan(cfg))
    routing = lambda tokens: TR.collective_bytes(
        "all-gather", 2 * tokens * cfg.top_k * 8, 2)[0]
    assert n_moe > 0 and B * S < TL.MOE_EP_MIN_TOKENS
    assert wire["prefill"] - wire["decode"] == pytest.approx(
        n_moe * (routing(B // 2 * S) - routing(B // 2)))
