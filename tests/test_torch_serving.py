"""The port's read tier against the JAX package's, in one process and
without sockets: the snapshot ring, the PSD1 delta payload (exact and
int8 lossy) byte for byte, ``_flat_segments`` on the MLP, ResNet-18 and
ResNet-50 templates, the PSR1 request bytes, the FRS1 trailers, the
serving core's read path, and the registry's Prometheus text. The same
numpy inputs, made from seeds, go to both packages; every comparison is
bit for bit unless it says otherwise. The socket tests are in
``test_torch_serving_net.py``."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.serving import DeltaCodec as JDeltaCodec
from pytorch_ps_mpi_tpu.serving import delta as jdelta
from pytorch_ps_mpi_tpu.serving import net as jnet
from pytorch_ps_mpi_tpu.telemetry import freshness as jfresh
from pytorch_ps_mpi_tpu.telemetry import registry as jreg
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.serving import (DeltaCodec, ServingCore,
                                              SnapshotStore)
from pytorch_ps_mpi_tpu_torch.serving import delta as tdelta
from pytorch_ps_mpi_tpu_torch.serving import net as tnet
from pytorch_ps_mpi_tpu_torch.telemetry import MetricsRegistry
from pytorch_ps_mpi_tpu_torch.telemetry import diagnosis, lineage
from pytorch_ps_mpi_tpu_torch.telemetry import freshness as tfresh

TMPL = {"a": np.zeros((700, 4), np.float32), "b": np.zeros((13,), np.float32)}
N = 700 * 4 + 13
KW = {"ring": 4, "admission_depth": 64, "retry_after_s": 0.005,
      "delta_bucket_mb": 0.002}


def flat_of(seed) -> np.ndarray:
    return np.random.RandomState(seed).randn(N).astype(np.float32)


def make_core(**cfg_extra):
    cfg = {"serving": True, "serving_kw": dict(KW), "device": "cpu"}
    cfg.update(cfg_extra)
    return ServingCore(None, cfg, template=TMPL)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


# -- snapshot ring -------------------------------------------------------------

def test_snapshot_ring_evicts_refcounts_and_freezes():
    st = SnapshotStore(ring=3)
    for v in range(1, 5):
        st.put(v, np.full(8, float(v), np.float32))
    assert st.versions() == [2, 3, 4] and st.get(1) is None
    held = st.acquire(2)
    st.put(5, np.full(8, 5.0, np.float32))
    st.put(6, np.full(8, 6.0, np.float32))
    # out of the ring, alive while held
    assert st.get(2) is None and held.flat[0] == 2.0
    assert st.snapshot()["zombies"] == 1
    st.release(held)
    assert st.snapshot()["zombies"] == 0 and st.refs_out() == 0
    snap = st.latest()
    assert not snap.flat.flags.writeable and snap.view().readonly
    with pytest.raises(ValueError):
        snap.flat[0] = 9.0
    # a re-publish of a pinned version replaces it cleanly
    pinned = st.acquire(6)
    st.put(6, np.zeros(8, np.float32))
    assert st.versions() == [4, 5, 6] and pinned.flat[0] == 6.0
    st.release(pinned)
    assert st.acquire(99) is None


# -- the PSD1 delta payload ----------------------------------------------------

def _changed(kind: str):
    base = flat_of(0)
    latest = base.copy()
    if kind == "sparse":
        latest[[3, 500, 2000, N - 1]] = [np.nan, -0.0, 7.25, 1e-40]
    elif kind == "dense":
        latest[2800:] += 1.0  # section b rewritten: dense
        latest[10] += 1.0  # one element of section a: sparse
    elif kind == "unchanged":
        pass
    elif kind == "full_fallback":
        latest += 1.0
    return base, latest


def _modes(payload: np.ndarray) -> list:
    """The section modes of a PSD1 payload (0 sparse, 1 dense, 2 lossy)."""
    n = int(payload[4:8].view(np.uint32)[0])
    off, modes = 16, []
    for _ in range(n):
        mode, _, count, size = payload[off:off + 16].view(np.uint32)
        modes.append(int(mode))
        off += 16 + (8 * int(size) if mode == 0 else 4 * int(count)
                     if mode == 1 else int(size))
    assert off == payload.nbytes
    return modes


@pytest.mark.parametrize("kind", ["sparse", "dense", "unchanged",
                                  "full_fallback"])
def test_exact_payload_equals_jax_and_applies_across(kind):
    base, latest = _changed(kind)
    mine = DeltaCodec(TMPL, bucket_mb=0.002, min_saving=0.5, device="cpu")
    theirs = JDeltaCodec(TMPL, bucket_mb=0.002, min_saving=0.5)
    got, want = mine.encode(base, latest), theirs.encode(base, latest)
    if kind == "full_fallback":
        assert got is None and want is None
        return
    assert got.tobytes() == want.tobytes()
    assert _modes(got) == {"sparse": [0, 0], "dense": [0, 1],
                           "unchanged": []}[kind]
    for payload in (got, want):
        assert same_bits(mine.apply(base, payload), latest)
        assert same_bits(theirs.apply(base, payload), latest)


class _JittedCodec:
    """A JAX codec whose encode is compiled, as the JAX package's step
    runs it (its ``DeltaCodec`` calls the codec op by op)."""

    def __init__(self, code):
        self._code = code
        self.needs_rng = code.needs_rng
        self._encode = jax.jit(lambda g: code.encode(g)[0])

    def init_state(self, *args):
        return self._code.init_state(*args)

    def encode(self, grad, state=(), rng=None):
        return self._encode(grad), state

    def decode(self, *args):
        return self._code.decode(*args)


def _lossy_pair(probe_every: int = 1):
    kw = dict(bucket_mb=0.002, codec="int8", probe_every=probe_every)
    mine = DeltaCodec(TMPL, device="cpu", **kw)
    theirs = JDeltaCodec(TMPL, **kw)
    base = flat_of(0)
    step = np.random.RandomState(1).randn(N).astype(np.float32) * 1e-3
    latest = base + step
    latest[:100] = base[:100]  # an unchanged stretch
    return mine, theirs, base, latest


def test_int8_lossy_payload_equals_the_compiled_jax_encode():
    mine, theirs, base, latest = _lossy_pair()
    theirs.code = _JittedCodec(theirs.code)
    got, want = mine.encode(base, latest), theirs.encode(base, latest)
    assert got.tobytes() == want.tobytes()
    # both sections went lossy: header + (16-byte section + q + scale) each
    assert _modes(got) == [2, 2]
    assert got.nbytes == 16 + sum(16 + c + 4 for _, c in mine.segments)
    assert mine.lossy_ok and theirs.lossy_ok
    assert mine.last_probe_rel_error == theirs.last_probe_rel_error < 0.05
    assert (mine.encodes, mine.lossy_encodes, mine.probes) == (1, 2, 2)
    a, b = mine.apply(base, got), theirs.apply(base, got)
    assert same_bits(a, b)
    rel = np.linalg.norm(a - latest) / np.linalg.norm(latest - base)
    assert rel < 0.05  # the probe's bound


@pytest.mark.parametrize("seed", range(40))
def test_int8_lossy_payload_against_the_eager_jax_encode(seed):
    # queue 3 item 20: op by op the JAX int8 encode divides max|x| by 127
    # (codecs/quant.py:130) where the compiled one, and the port, multiply
    # by f32(1/127); the scale may differ by one ulp and a code by one
    # step (seed 0's payloads differ), the section table agrees
    rng = np.random.RandomState(seed)
    base = rng.randn(N).astype(np.float32)
    latest = base + (rng.randn(N).astype(np.float32)
                     * np.float32(10.0 ** rng.uniform(-6, 2)))
    mine = DeltaCodec(TMPL, bucket_mb=0.002, codec="int8", device="cpu")
    theirs = JDeltaCodec(TMPL, bucket_mb=0.002, codec="int8")
    got, want = mine.encode(base, latest), theirs.encode(base, latest)
    assert got.nbytes == want.nbytes and _modes(got) == [2, 2]
    assert got[:16].tobytes() == want[:16].tobytes()
    off = 16
    for start, count in mine.segments:
        assert got[off:off + 16].tobytes() == want[off:off + 16].tobytes()
        off += 16
        q_got = got[off:off + count].view(np.int8).astype(np.int32)
        q_want = want[off:off + count].view(np.int8).astype(np.int32)
        assert np.abs(q_got - q_want).max() <= 1
        s_got = got[off + count:off + count + 4].view(np.float32)
        s_want = want[off + count:off + count + 4].view(np.float32)
        np.testing.assert_array_max_ulp(s_got, s_want, 1)
        off += count + 4
    assert off == got.nbytes


def test_lossy_probe_turns_a_mangling_codec_off_for_good():
    base = flat_of(0)
    latest = base + np.random.RandomState(1).randn(N).astype(np.float32)
    mine = DeltaCodec(TMPL, bucket_mb=0.0, codec="sign", probe_every=1,
                      device="cpu")
    theirs = JDeltaCodec(TMPL, bucket_mb=0.0, codec="sign", probe_every=1)
    got, want = mine.encode(base, latest), theirs.encode(base, latest)
    assert (mine.lossy_ok, mine.lossy_fallbacks) == (False, 1)
    assert (theirs.lossy_ok, theirs.lossy_fallbacks) == (False, 1)
    assert got is None and want is None  # exact is no saving: full read


@pytest.mark.parametrize("model", ["mlp", "resnet18", "resnet50"])
def test_flat_segments_equal_jax(model):
    cfg = {"model": model, "in_shape": [8] if model == "mlp" else [32, 32, 3],
           "model_kw": ({"features": (64, 8)} if model == "mlp"
                        else {"num_classes": 10}), "seed": 0}
    tmpl = at.make_problem(cfg, "cpu").template
    total = sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tmpl))
    for mb in (0.0, 0.001, 1.0, 4.0):
        got = tdelta._flat_segments(tmpl, mb, total)
        assert got == jdelta._flat_segments(tmpl, mb, total), (model, mb)
        assert sum(c for _, c in got) == total


# -- the PSR1 request and the FRS1 trailer --------------------------------------

def test_request_bytes_and_wire_constants_equal_jax():
    for have, delta, tenant, fresh in ((0, True, "", False),
                                       (7, False, "job-a", True),
                                       (2 ** 40, True, "shard1", True)):
        assert tnet.pack_request(have, delta, tenant, fresh) \
            == jnet.pack_request(have, delta, tenant, fresh)
    assert (tnet.MAGIC, tnet._REQ.format, tnet._REP.format) \
        == (jnet.MAGIC, jnet._REQ.format, jnet._REP.format)
    assert tnet.KIND_NAMES == jnet.KIND_NAMES
    assert (tdelta.MAGIC, tdelta.DELTA_KNOBS) \
        == (jdelta.MAGIC, jdelta.DELTA_KNOBS)


def test_freshness_trailers_equal_jax():
    blob_t = tfresh.pack_birth(42, 1000.5, root_gen=3)
    blob_j = jfresh.pack_birth(42, 1000.5, root_gen=3)
    for i in range(tfresh.FRESH_HOP_CAP + 2):  # past the cap: saturates
        blob_t = tfresh.append_hop(blob_t, i + 1, 1000.5 + 0.001 * i,
                                   skew_ms=0.25 * i - 1.0)
        blob_j = jfresh.append_hop(blob_j, i + 1, 1000.5 + 0.001 * i,
                                   skew_ms=0.25 * i - 1.0)
        assert blob_t == blob_j
    assert len(blob_t) == tfresh.FRESH_MAX_BYTES
    doc_t, doc_j = tfresh.unpack_trailer(blob_t), jfresh.unpack_trailer(blob_j)
    assert doc_t == doc_j
    for fn in ("total_skew_s", "birth_wall_local", "visible_latency_ms",
               "hop_latencies_ms"):
        assert getattr(tfresh, fn)(doc_t) == getattr(jfresh, fn)(doc_j), fn
    assert tfresh.age_ms(doc_t, now=2000.0) == jfresh.age_ms(doc_j,
                                                             now=2000.0)
    for bad in (blob_t[:-1], blob_t[:10], blob_t + b"\x00",
                b"XXXX" + blob_t[4:], b""):
        with pytest.raises(ValueError):
            tfresh.unpack_trailer(bad)


def test_clock_offset_and_ewma_equal_jax():
    from pytorch_ps_mpi_tpu.telemetry import diagnosis as jdiag
    from pytorch_ps_mpi_tpu.telemetry import lineage as jlin

    pairs = [(1.0, 1.25), (2.0, 2.125), (3.0, 3.5)]
    assert lineage.estimate_clock_offset(pairs) \
        == jlin.estimate_clock_offset(pairs) == 0.125
    with pytest.raises(ValueError):
        lineage.estimate_clock_offset([])
    mine, theirs = diagnosis.Ewma(0.25), jdiag.Ewma(0.25)
    assert mine.value is None
    for x in (2.0, 0.0, 0.0, 5.0):
        assert mine.update(x) == theirs.update(x)


# -- the registry ------------------------------------------------------------

def test_read_latency_histogram_renders_jax_text():
    obs = np.random.RandomState(3).lognormal(-7.0, 2.0, 200).tolist()
    obs += [0.0, 1e-5, 2.5, 100.0]  # on a bound, past the last one
    out = []
    for reg in (MetricsRegistry(), jreg.MetricsRegistry()):
        h = reg.histogram("ps_read_seconds", (1e-5, 1e-4, 1e-3, 1e-2, 0.1,
                                              1.0, 2.5), "read time")
        for x in obs:
            h.observe(x)
        reg.counter("ps_reads_total", "reads").set(204)
        reg.gauge("ps_read_p95_ms", "p95", labels={"tenant": "a"}).set(
            h.approx_quantile(0.95) * 1e3)
        reg.add_collector(lambda r: r.gauge("ps_serving_tenants").set(2))
        out.append((reg.prometheus_text(), h.approx_quantile(0.5),
                    h.approx_quantile(0.99)))
    assert out[0] == out[1]


# -- the serving core's read path --------------------------------------------

def test_core_answers_not_modified_delta_full_and_ageout():
    core = make_core()
    v1 = flat_of(0)
    core.publish(flat=v1.copy())
    kind, ver, _, payload, done = core.handle_read(have_version=0)
    assert (kind, ver) == (tnet.KIND_FULL, 1) and payload.nbytes == N * 4
    done()
    kind, _, _, payload, _ = core.handle_read(have_version=1)
    assert kind == tnet.KIND_NOT_MODIFIED and payload is None
    v2 = v1.copy()
    v2[7] += 1.0
    core.publish(flat=v2.copy())
    kind, ver, base, payload, _ = core.handle_read(have_version=1)
    assert (kind, ver, base) == (tnet.KIND_DELTA, 2, 1)
    # the payload is the JAX package's delta of the same two versions
    assert payload.tobytes() == JDeltaCodec.from_knobs(TMPL, KW).encode(
        v1, v2).tobytes()
    kind2, _, _, payload2, _ = core.handle_read(have_version=1)
    assert kind2 == tnet.KIND_DELTA and payload2 is payload  # coalesced
    assert core.coalesce_hits == 1
    for i in range(5):  # version 1 ages out of the 4-deep ring
        bump = v2.copy()
        bump[0] = float(i)
        core.publish(flat=bump)
    kind, _, _, _, done = core.handle_read(have_version=1)
    assert kind == tnet.KIND_FULL and core.ring_ageouts == 1
    done()
    m = core.read_metrics()
    assert m["reads_total"] == 5.0 and m["reads_not_modified"] == 1.0
    assert m["delta_bytes_saved"] > 0
    assert core._stores["default"].refs_out() == 0
    core.close()


def test_core_tenants_zero_copy_fanout_and_unarmed_publish():
    core = make_core()
    core.publish(flat=np.full(N, 0.5, np.float32), tenant="job-a",
                 template=TMPL)
    core.publish(flat=np.full(N, 1.5, np.float32), tenant="job-b",
                 template=TMPL)
    core.publish(flat=np.full(N, 2.5, np.float32), tenant="job-b")
    _, va, _, pa, da = core.handle_read(have_version=0, tenant="job-a")
    _, vb, _, pb, db = core.handle_read(have_version=0, tenant="job-b")
    assert (va, vb, pa[0], pb[0]) == (1, 2, 0.5, 2.5)
    da(), db()
    kind, _, _, msg, _ = core.handle_read(tenant="nope")
    assert kind == tnet.KIND_ERROR and b"unknown tenant" in bytes(msg)
    snap = core.serving_snapshot()
    assert snap["tenants"]["job-b"]["reads"] == 1
    assert snap["tenants"]["job-b"]["latest"] == 2
    core.publish(flat=flat_of(3))
    snaps = [core.acquire_latest() for _ in range(4)]
    addr = {s.flat.__array_interface__["data"][0] for s in snaps}
    assert len(addr) == 1  # one buffer fanned out
    for s in snaps:
        core.release(s)
    assert core._stores["default"].refs_out() == 0
    core.close()
    unarmed = ServingCore(None, {"device": "cpu"}, template=TMPL)
    assert not unarmed.armed
    with pytest.raises(ValueError):
        unarmed.publish(flat=flat_of(0))


class _Transport:
    """What a serving core needs of a PS server: ``publish_flat`` (each
    array it was handed kept), ``version`` and a scrape registry."""

    def __init__(self):
        self.version, self.handed = 0, []
        self.template, self.device = TMPL, torch.device("cpu")
        self._reg = MetricsRegistry()

    def scrape_registry(self):
        return self._reg

    def publish_flat(self, flat):
        self.handed.append(flat)
        self.version += 1


@pytest.mark.parametrize("armed", [True, False])
def test_publish_device_owns_the_host_copy(armed):
    server = _Transport()
    cfg = ({"serving": True, "serving_kw": dict(KW)} if armed else {})
    core = ServingCore(server, cfg)
    flats = [flat_of(s) for s in (4, 5)]
    for f in flats:
        assert core.publish_device(torch.from_numpy(f.copy())) == \
            server.version
    a, b = server.handed
    if armed:
        # each version keeps its own array, in the ring and at the wire
        assert a.ctypes.data != b.ctypes.data
        for v, f in zip((1, 2), flats):
            snap = core._stores["default"].acquire(v)
            assert same_bits(snap.flat, f)
            core.release(snap)
        assert same_bits(a, flats[0]) and same_bits(b, flats[1])
        t = core.publish_times
        assert t["alloc_s"] > 0.0 and t["d2h_s"] > 0.0
        assert core.publishes == 2
    else:
        # unarmed: one buffer, refilled every publish, no ring, no timers
        assert a.ctypes.data == b.ctypes.data and same_bits(b, flats[1])
        assert core._stores == {} and core.publishes == 0
        assert core.publish_times["d2h_s"] == 0.0
    core.close()


def test_relayed_trailers_and_age_of_the_served_version():
    core = make_core()
    core.publish(flat=flat_of(0))
    doc = tfresh.unpack_trailer(core.fresh_trailer(version=1))
    assert (doc["version"], doc["hop_count"]) == (1, 0)
    a1 = core.serving_age_ms()
    assert core.serving_age_ms() >= a1
    relayed = tfresh.append_hop(tfresh.pack_birth(2, 1.0e9, 7), 1,
                                1.0e9 + 0.004, skew_ms=1.0)
    core.publish(flat=flat_of(1), fresh=relayed)
    assert core.fresh_trailer(version=2) == relayed
    assert core.fresh_trailer(version=1) == b""  # raced to another version
    m = core.read_metrics()
    assert m["fresh_hop_count"] == 1.0
    assert m["read_fresh_p50_ms"] == pytest.approx(3.0, abs=1e-3)
    core.publish(flat=flat_of(2), fresh=b"")  # nothing to relay
    assert core.fresh_trailer() == relayed  # the last trailer installed
    core.publish(flat=flat_of(3), fresh=b"FRS1broken")
    assert core.fresh_trailer() == relayed  # a malformed relay is dropped
    core.close()
