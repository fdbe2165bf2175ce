"""The port's wire against the JAX package's, byte for byte: the
serialization helpers, ``CodecWire``'s spec (``wire_bytes`` and the flat
payload specs) for all 14 registered codec names per leaf and at
``bucket_mb=16``, the payload bytes and their decode, the wire
fingerprint (its treedef string among them) for the MLP, ResNet-18 and
ResNet-50 templates, the PSF2 frame seal and every rejection reason.

Payload bytes are equal for the deterministic codecs except the float
sidecars ROADMAP queue 3 items 2 and 11 document (sign's scale and
threshold's mean, rtol 1e-6) and PowerSGD, whose warm-start Q and QR are
the port's own (item 10; its decodes agree to 1e-5 once the JAX state is
carried across). The stochastic codecs agree byte for byte given the JAX
wire's own random numbers."""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import models as jm
from pytorch_ps_mpi_tpu.codecs import get_codec as jax_codec
from pytorch_ps_mpi_tpu.parallel import dcn as jdcn
from pytorch_ps_mpi_tpu.resilience import frames as jframes
from pytorch_ps_mpi_tpu.utils import serialization as jser
from pytorch_ps_mpi_tpu_torch import models as tm
from pytorch_ps_mpi_tpu_torch.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import dcn as tdcn
from pytorch_ps_mpi_tpu_torch.resilience import frames as tframes
from pytorch_ps_mpi_tpu_torch.utils import serialization as tser
from pytorch_ps_mpi_tpu_torch.utils.interop import params_to_jax

#: all 14 registered names, with settings that reach their main paths
ALL_CODECS = [
    ("identity", {}), ("bf16", {}), ("f16", {}), ("sign", {}),
    ("int8", {}), ("qsgd", {}), ("topk", {"fraction": 0.05}),
    ("ef", {"inner_name": "sign"}), ("terngrad", {"use_pallas": True}),
    ("randomk", {"fraction": 0.05}), ("blocktopk", {"fraction": 0.05}),
    ("blocktopk8", {"fraction": 0.05}), ("threshold", {}),
    ("powersgd", {"rank": 2}),
]
IDS = [n for n, _ in ALL_CODECS]
STOCHASTIC = ("qsgd", "terngrad", "randomk")


def _template():
    """Leaves of the kernel layouts (sizes dividing 1024 and 512) and of
    the flat ones."""
    rng = np.random.RandomState(1)
    return {"params": {
        "Conv_0": {"kernel": rng.randn(3, 3, 16, 32).astype(np.float32)},
        "Dense_0": {"kernel": rng.randn(64, 96).astype(np.float32),
                    "bias": rng.randn(96).astype(np.float32)},
        "Dense_1": {"kernel": rng.randn(96, 10).astype(np.float32),
                    "bias": rng.randn(10).astype(np.float32)}}}


def _grads(tmpl, seed=2):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                        tmpl)


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


# -- serialization ------------------------------------------------------------

def test_pack_pytree_bytes_and_spec_match_jax():
    tree = {"b": np.arange(6, dtype=np.int8).reshape(2, 3),
            "a": {"x": np.linspace(0, 1, 5, dtype=np.float32),
                  "y": np.array(3.5, np.float64)},
            "c": [np.ones(2, np.int32), (np.zeros(1, np.uint8),)]}
    jbuf, jspec = jser.pack_pytree(tree)
    tbuf, tspec = tser.pack_pytree(tree)
    assert bytes(tbuf) == bytes(jbuf) and tspec == jspec
    back = tser.unpack_pytree(bytes(jbuf), jspec, template=tree, copy=False)
    for a, b in zip(tser.tree_flatten(back)[0], jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError) as terr:
        tser.unpack_pytree(bytes(jbuf)[:-1], jspec, template=tree)
    with pytest.raises(ValueError) as jerr:
        jser.unpack_pytree(bytes(jbuf)[:-1], jspec, template=tree)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("compress", [False, True])
def test_save_pytree_files_cross_both_ways(tmp_path, compress):
    tree = {"w": np.random.RandomState(0).randn(64, 8).astype(np.float32),
            "n": {"count": np.array([0, 0, 5, 0], np.int32)}}
    tser.save_pytree(str(tmp_path / "t.npz"), tree, compress=compress)
    jser.save_pytree(str(tmp_path / "j.npz"), tree, compress=compress)
    for src, loader in (("t.npz", jser.load_pytree),
                        ("j.npz", tser.load_pytree)):
        back = loader(str(tmp_path / src), tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)
    if compress:
        assert (tmp_path / "t.npz").read_bytes() != b""
        from pytorch_ps_mpi_tpu.utils import native as jnative
        from pytorch_ps_mpi_tpu_torch.utils import native as tnative

        raw = tree["w"].tobytes()
        assert tnative.compress(raw) == jnative.compress(raw)
        assert tnative.decompress(jnative.compress(raw)) == raw


def test_treedef_strings_match_jax():
    for t in [{"params": {"b": 1, "a": {"x": 2}}}, [1, (2,)], (1, None),
              {"ResNetBlock_10": 1, "ResNetBlock_2": 2}]:
        leaves, td = tser.tree_flatten(t)
        assert str(td) == str(jax.tree.structure(t))
        assert leaves == jax.tree.leaves(t)
        assert td.unflatten(leaves) == t


# -- the codec wire -----------------------------------------------------------

@pytest.mark.parametrize("bucket_mb", [0.0, 16.0])
@pytest.mark.parametrize("name,kw", ALL_CODECS, ids=IDS)
def test_wire_spec_and_fingerprint_match_jax(name, kw, bucket_mb):
    tmpl = _template()
    jw = jdcn.CodecWire(jax_codec(name, **kw), tmpl, bucket_mb=bucket_mb)
    tw = tdcn.CodecWire(get_codec(name, **kw), tmpl, bucket_mb=bucket_mb,
                        device="cpu")
    assert tw.wire_bytes == jw.wire_bytes
    assert tw.raw_bytes == jw.raw_bytes
    assert [tuple(s) for s in tw.shapes] == [tuple(s) for s in jw.shapes]
    assert tw.spec_names == [(tuple(s), str(np.dtype(d)))
                             for s, d in jw._flat_specs]
    assert (tframes._codec_desc(tw.code) == jframes._codec_desc(jw.code))
    assert (tframes.wire_fingerprint(tw, tmpl)
            == jframes.wire_fingerprint(jw, tmpl))
    assert tw.agg_supported == jw.agg_supported


def _jax_unit_keys(seed, n_units, rounds):
    """The keys the JAX wire hands its units, round by round."""
    rng = jax.random.key(seed)
    out = []
    for _ in range(rounds):
        rng, sub = jax.random.split(rng)
        out.append(list(jax.random.split(sub, n_units)))
    return out


def _port_payload_with_jax_draws(code, unit, key):
    """The port codec's payload of one unit given the JAX encode's own
    random numbers (``codecs/quant.py:171``, ``randomk.py:72``,
    ``terngrad.py:83``)."""
    g = torch.from_numpy(np.asarray(unit))
    if isinstance(code, type(get_codec("qsgd"))):
        u = np.array(jax.random.uniform(key, (g.numel(),)))
        return code.quantize(g, torch.from_numpy(u))
    if isinstance(code, type(get_codec("randomk", k=1))):
        k = code._k_for(tuple(g.shape))
        return code.sample(g, torch.from_numpy(
            np.array(jax.random.uniform(key, (k,)))))
    n = g.numel()
    if code._pallas_ok(n):
        bits = np.array(jax.random.bits(key, (n,), jnp.uint32))
        draw = torch.from_numpy(bits.view(np.int32))
    else:  # drawn in the leaf's own shape, then flattened
        draw = torch.from_numpy(np.array(
            jax.random.uniform(key, tuple(g.shape))).reshape(-1))
    return code.ternarize(g, lambda chunk, size: draw)


@pytest.mark.parametrize("name,kw", ALL_CODECS, ids=IDS)
def test_payload_bytes_and_decode_match_jax(name, kw):
    tmpl = _template()
    jw = jdcn.CodecWire(jax_codec(name, **kw), tmpl)
    tw = tdcn.CodecWire(get_codec(name, **kw), tmpl, device="cpu")
    grads = _grads(tmpl)
    jb = np.array(jw.encode_to_bytes(grads))
    if name in STOCHASTIC:
        keys = _jax_unit_keys(0, len(jw.shapes), 1)[0]
        payloads = [_port_payload_with_jax_draws(tw.code, u, k) for u, k in
                    zip(jax.tree.leaves(grads), keys)]
        tb = np.empty(tw.wire_bytes, np.uint8)
        arrays = [p[k] for p in payloads for k in sorted(p)]
        tser.pack_arrays_into(tb, [a.numpy() for a in arrays])
    else:
        tb = np.array(tw.encode_to_bytes(_torch_tree(grads)))
    assert tb.nbytes == jb.nbytes == jw.wire_bytes
    jp, tp = jw.payloads_from_bytes(jb), tw.payloads_from_bytes(tb)
    for u, (a, b) in enumerate(zip(jp, tp)):
        for key in (sorted(a) if isinstance(a, dict) else [None]):
            x = np.asarray(a[key] if key else a)
            y = b[key] if key else b
            if name == "powersgd":
                continue  # the port's own warm-start Q (queue 3 item 10)
            if key in ("scale", "norm") and name in ("sign", "ef", "qsgd"):
                np.testing.assert_allclose(y, x, rtol=1e-6)  # item 2
            elif name == "bf16":
                np.testing.assert_array_equal(y, x.view(np.uint16))
            else:
                np.testing.assert_array_equal(y, x)
    if name == "powersgd":
        return
    # the port decodes the JAX bytes as the JAX wire does
    want = jax.tree.leaves(jw.decode_from_bytes(jb))
    got = tw.decode_leaves(jb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_powersgd_decodes_match_jax_with_its_state_carried():
    tmpl = _template()
    jw = jdcn.CodecWire(jax_codec("powersgd", rank=2), tmpl)
    tw = tdcn.CodecWire(get_codec("powersgd", rank=2), tmpl, device="cpu")
    tw._states = [jax.tree.map(lambda x: torch.from_numpy(np.array(x)), s)
                  for s in jw._states]
    grads = _grads(tmpl)
    jb = np.array(jw.encode_to_bytes(grads))
    tb = np.array(tw.encode_to_bytes(_torch_tree(grads)))
    for g, w in zip(tw.decode_leaves(tb),
                    jax.tree.leaves(jw.decode_from_bytes(jb))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def _jax_resnet_template(ctor, **kw):
    model = ctor(num_classes=10, small_inputs=True, **kw)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.mark.parametrize("which", ["mlp", "resnet18", "resnet50"])
def test_fingerprints_of_model_templates_match_jax(which):
    if which == "mlp":
        jt = jax.tree.map(np.asarray, jm.MLP(features=(32, 8)).init(
            jax.random.key(0), jnp.zeros((1, 8))))
        model = tm.MLP(features=(32, 8), in_features=8, device="cpu")
    elif which == "resnet18":
        jt = _jax_resnet_template(jm.ResNet18, num_filters=32)
        model = tm.ResNet18(num_classes=10, num_filters=32,
                            small_inputs=True, device="cpu")
    else:
        jt = _jax_resnet_template(jm.ResNet50)
        model = tm.ResNet50(num_classes=10, small_inputs=True, device="cpu")
    tt = params_to_jax(model)
    assert str(tser.tree_flatten(tt)[1]) == str(jax.tree.structure(jt))
    assert [a.shape for a in tser.tree_flatten(tt)[0]] == \
        [a.shape for a in jax.tree.leaves(jt)]
    assert (tframes.wire_fingerprint(None, tt)
            == jframes.wire_fingerprint(None, jt))
    if which != "resnet50":
        jw = jdcn.CodecWire(jax_codec("sign"), jt)
        tw = tdcn.CodecWire(get_codec("sign"), tt, device="cpu")
        assert (tframes.wire_fingerprint(tw, tt)
                == jframes.wire_fingerprint(jw, jt))


# -- frames --------------------------------------------------------------------

def test_seal_frame_bytes_match_jax():
    payload = np.random.RandomState(4).randint(0, 256, 1000).astype(np.uint8)
    fp = 0x1234_5678_9ABC_DEF0
    jout = np.empty(jframes.HEADER_BYTES + 1000, np.uint8)
    tout = np.empty(tframes.HEADER_BYTES + 1000, np.uint8)
    jf = jframes.seal_frame(jout, payload, fp, step=7, seq=9,
                            send_wall=1234.5)
    tf = tframes.seal_frame(tout, payload, fp, step=7, seq=9,
                            send_wall=1234.5)
    np.testing.assert_array_equal(tf, jf)
    assert tframes.read_lineage(tf) == jframes.read_lineage(jf) == \
        (7, 9, 1234.5)
    assert (tframes.HEADER_BYTES, tframes.FRAME_MAGIC, tframes.FRAME_MAGIC_V1,
            tframes.BATCH_REASONS) == (
        jframes.HEADER_BYTES, jframes.FRAME_MAGIC, jframes.FRAME_MAGIC_V1,
        jframes.BATCH_REASONS)


def _bad_frames():
    fp = 0xABCDEF
    payload = np.arange(64, dtype=np.uint8)
    good = tframes.seal_frame(np.empty(36 + 64, np.uint8), payload, fp).copy()
    v1 = good.copy()
    struct.pack_into("<I", v1, 0, tframes.FRAME_MAGIC_V1)
    garbage = good.copy()
    struct.pack_into("<I", garbage, 0, 0xDEADBEEF)
    corrupt = good.copy()
    corrupt[50] ^= 0xFF
    return fp, [
        ("valid", good, 64), ("short", good[:3], None),
        ("version", v1, None), ("magic", garbage, None),
        ("short-header", good[:20], None), ("size-declared", good[:-1], None),
        ("size-expected", good, 63), ("corrupt", corrupt, 64),
    ]


def test_every_rejection_reason_matches_jax():
    fp, cases = _bad_frames()
    reasons = []
    for label, buf, expected in cases:
        tp, terr = tframes.open_frame(buf, fp, expected)
        jp, jerr = jframes.open_frame(buf, fp, expected)
        assert terr == jerr, label
        reasons.append(terr)
        if terr is None:
            np.testing.assert_array_equal(tp, jp)
    _, jerr = jframes.open_frame(cases[0][1], fp + 1, 64)
    assert tframes.open_frame(cases[0][1], fp + 1, 64)[1] == jerr == "config"
    assert set(reasons) | {"config"} == {None, *jframes.BATCH_REASONS.values()}


def test_tree_slots_name_their_item():
    # ported: a tree wire's slot count joins the fingerprint as in JAX
    for slots in (0, 2):
        assert tframes.wire_fingerprint(None, _template(),
                                        tree_slots=slots) == \
            jframes.wire_fingerprint(None, _template(), tree_slots=slots)
