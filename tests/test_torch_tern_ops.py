"""The port's TernGrad pack and unpack(-sum) plain versions against the
JAX package's Pallas kernels (``ops/tern_pallas.py``, interpret mode on
the CPU), fed the same uint32 random bits: packed bytes and unpacked
floats are bit-exact, at sizes 512 to 2**16 and on planted cases. The
one-launch encode's and the scale-only entry's plain versions, from
float32 and bf16, give the JAX codec's scale ``jnp.maximum(jnp.max(
jnp.abs(g)), 1e-12)`` bit for bit (NaN, ±Inf and max|x| < 1e-12
included) and its Pallas pack with that scale. The
unpack-sum of several ranks equals the rank-ordered fold bit for bit and
the JAX codec's ``einsum("wn,w->n")`` to rtol 1e-6 (XLA's dot sums in its
own order). The CUDA kernels are held to these plain versions in
``test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_ps_mpi_tpu.ops import tern_pallas
from pytorch_ps_mpi_tpu_torch.ops import tern as T

SIZES = [512, 1536, 8192, 1 << 16]
SCALE = 4.0  # the planted cases' scale: 2**24 / 4 is exact


def _bits(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2**32, size=n,
                                               dtype=np.uint64).astype(np.uint32)


def _case(n: int, case: str):
    """(x, uint32 bits, scale) for a size and a case."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    bits = _bits(n, n + 1)
    if case == "plain":
        return x, bits, float(np.abs(x).max())
    x = x * 0.5
    x[[0, 1, 2, 3]] = [-0.0, np.nan, np.inf, -np.inf]
    # |x| == s: p24 = 2**24 lies above every 24-bit u, always kept
    x[4], bits[4] = -SCALE, 0xFFFFFFFF
    # u24 == p24 drops the element; one below keeps it
    x[5], bits[5] = 0.5, (2097152 << 8) | 0xFF
    x[6], bits[6] = 0.5, ((2097152 - 1) << 8) | 0xFF
    # the top bit set: a logical shift gives 2**23 > p24 = 2**22 (dropped);
    # an arithmetic shift would give a negative u24 and keep it
    x[7], bits[7] = 0.25 * SCALE, 0x80000000
    return x, bits, SCALE


def _pack_both(x, bits, scale):
    got = T.tern_pack(torch.from_numpy(x), torch.from_numpy(bits.view(np.int32)),
                      torch.tensor(scale, dtype=torch.float32))
    want = tern_pallas.tern_pack(jnp.asarray(x), jnp.asarray(bits),
                                 jnp.float32(scale))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["plain", "planted"])
@pytest.mark.parametrize("n", SIZES)
def test_pack_matches_pallas(n, case):
    got, want = _pack_both(*_case(n, case))
    assert got.dtype == np.uint8 and got.shape == (n // 4,)
    np.testing.assert_array_equal(got, want)
    if case == "planted":
        tern = T.tern_digits(torch.from_numpy(got)).numpy()
        # ±0.0 never keeps (p24 = 0; kept, -0.0 would take digit 2 as
        # x >= 0); NaN never keeps; Inf with a finite scale keeps; |x| == s
        # keeps; u24 == p24 drops; u24 == p24 - 1 keeps; the top bit is
        # shifted logically
        np.testing.assert_array_equal(tern[:8], [0, 0, 1, -1, -1, 0, 1, 0])


@pytest.mark.parametrize("scale", [np.nan, np.inf])
def test_pack_nonfinite_scale_drops_everything(scale):
    # nonfinite="propagate" with a NaN or Inf element makes the scale
    # non-finite: p24 is NaN or 0 (and Inf·0 = NaN), so no element keeps
    x, bits, _ = _case(1024, "plain")
    got, want = _pack_both(x, bits, scale)
    np.testing.assert_array_equal(got, want)
    assert (T.tern_digits(torch.from_numpy(got)) == 0).all()


@pytest.mark.parametrize("n", SIZES)
def test_unpack_matches_pallas_bit_exact(n):
    rng = np.random.RandomState(n)
    packed = rng.randint(0, 256, size=n // 4).astype(np.uint8)  # digit 3 too
    scale = np.float32(rng.rand() + 0.1)
    got = T.tern_unpack(torch.from_numpy(packed), torch.tensor(scale)).numpy()
    want = np.asarray(tern_pallas.tern_unpack(jnp.asarray(packed),
                                              jnp.float32(scale)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("world", [1, 4, 8])
def test_unpack_sum_is_the_rank_ordered_fold(world):
    m = 1 << 12
    rng = np.random.RandomState(world)
    packed = rng.randint(0, 256, size=(world, m)).astype(np.uint8)
    scales = (rng.rand(world) + 0.1).astype(np.float32)
    got = T.tern_unpack_sum(torch.from_numpy(packed),
                            torch.from_numpy(scales)).numpy()
    parts = [np.asarray(tern_pallas.tern_unpack(jnp.asarray(packed[w]),
                                                jnp.float32(scales[w])))
             for w in range(world)]
    fold = parts[0]
    for p in parts[1:]:
        fold = fold + p
    np.testing.assert_array_equal(got, fold)
    tern = np.stack([p / s for p, s in zip(parts, scales)]).astype(np.int8)
    einsum = np.asarray(jnp.einsum("wn,w->n", jnp.asarray(tern),
                                   jnp.asarray(scales),
                                   preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got, einsum, rtol=1e-6, atol=0)


def _encode_case(n: int, case: str) -> np.ndarray:
    x = np.random.RandomState(n + 3).randn(n).astype(np.float32)
    if case == "nan":
        x[n // 3] = np.nan
    elif case == "inf":
        x[1], x[-1] = np.inf, -np.inf
    elif case == "tiny":  # max|x| < 1e-12: the scale clamps
        x *= np.float32(1e-30)
    x[0] = -0.0
    return x


def _bits32(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).reshape(-1).view(np.int32)


@pytest.mark.parametrize("case", ["plain", "nan", "inf", "tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_encode_matches_the_jax_scale_and_pallas_pack(n, dtype, case):
    # the JAX codec casts to float32 first (codecs/terngrad.py:116); the
    # port reads the gradient in its own type
    jx = jnp.asarray(_encode_case(n, case)).astype(dtype)
    g = jx.astype(jnp.float32)
    bits = _bits(n, n + 2)
    want_scale = jnp.maximum(jnp.max(jnp.abs(g)), 1e-12)
    want = np.asarray(tern_pallas.tern_pack(g, jnp.asarray(bits), want_scale))
    tx = torch.from_numpy(np.array(g)).to(getattr(torch, dtype))
    tbits = torch.from_numpy(bits.view(np.int32))
    packed, scale = T.tern_encode(tx, tbits)
    assert packed.dtype == torch.uint8 and packed.shape == (n // 4,)
    assert scale.dtype == torch.float32 and scale.shape == ()
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(_bits32(scale.numpy()), _bits32(want_scale))
    np.testing.assert_array_equal(_bits32(T.tern_scale(tx).numpy()),
                                  _bits32(want_scale))
    np.testing.assert_array_equal(T.tern_pack(tx, tbits, scale).numpy(), want)
    if case in ("nan", "inf"):
        assert (T.tern_digits(packed) == 0).all()


def test_scale_ref_takes_the_max_chunk_by_chunk():
    # past 2**20 elements the plain scale is a running max over chunks,
    # as the JAX codec's chunked encode takes it
    x = np.random.RandomState(0).randn(3 << 19).astype(np.float32)
    x[(1 << 20) + 5] = 9.5
    want = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12)
    got = T.tern_scale_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits32(got.numpy()), _bits32(want))


def test_wrappers_take_the_plain_version_on_the_cpu():
    counters = (T.tern_encode, T.tern_scale, T.tern_pack, T.tern_unpack_sum)
    before = [k.launches for k in counters]
    x, bits, scale = _case(512, "plain")
    tx, tbits = torch.from_numpy(x), torch.from_numpy(bits.view(np.int32))
    packed = T.tern_pack(tx, tbits, torch.tensor(scale))
    T.tern_unpack(packed, torch.tensor(scale))
    T.tern_encode(tx, tbits)
    T.tern_scale(tx)
    out = torch.zeros(128, dtype=torch.uint8)
    assert T.tern_pack(tx, tbits, torch.tensor(scale), out=out) is out
    assert torch.equal(out, packed)
    assert [k.launches for k in counters] == before


@pytest.mark.parametrize("bad", ["size", "bits_dtype", "bits_len", "scales",
                                 "float16", "two_d", "scale_dtype",
                                 "scale_len", "out_len", "out_dtype",
                                 "scale_size", "unpack_m"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(1024)
    bits = torch.zeros(1024, dtype=torch.int32)
    one = torch.tensor(1.0)
    with pytest.raises(ValueError):
        if bad == "size":
            T.tern_pack(torch.zeros(1000), torch.zeros(1000, dtype=torch.int32),
                        one)
        elif bad == "bits_dtype":
            T.tern_pack(x, bits.to(torch.int64), one)
        elif bad == "bits_len":
            T.tern_pack(x, bits[:512], one)
        elif bad == "scales":
            T.tern_unpack_sum(torch.zeros(2, 256, dtype=torch.uint8),
                              torch.ones(3))
        elif bad == "float16":
            T.tern_encode(x.half(), bits)
        elif bad == "two_d":
            T.tern_encode(x.reshape(2, 512), bits)
        elif bad == "scale_dtype":
            T.tern_pack(x, bits, one.double())
        elif bad == "scale_len":
            T.tern_pack(x, bits, torch.ones(2))
        elif bad == "out_len":
            T.tern_pack(x, bits, one, out=torch.zeros(255, dtype=torch.uint8))
        elif bad == "out_dtype":
            T.tern_pack(x, bits, one, out=torch.zeros(256, dtype=torch.int8))
        elif bad == "scale_size":
            T.tern_scale(torch.zeros(1000))
        else:
            T.tern_unpack_sum(torch.zeros(1, 100, dtype=torch.uint8),
                              torch.ones(1))
