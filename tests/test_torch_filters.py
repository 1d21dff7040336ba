"""The port's Bloom-probe family held against the JAX package.

The same seeded numpy inputs go through ``repro`` (numpy path, jnp
reference, Pallas kernel in interpret mode) and ``repro_torch`` (plain
PyTorch version, ``ops`` entry points, ``filters`` routes).  Every result
is an integer bit image or a boolean hit mask, so every comparison here is
exact: no tolerance.  Keys include the adversarial set of
``tests/test_filters.py`` (0, 2**64-1 twice, a duplicate run).

The CUDA kernel itself runs only on the card: ``test_kernel_matches_plain``
carries the ``gpu`` marker and decides inside its fixture whether a card
and ``nvcc`` are present.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.bloom_probe.ops import probe as jax_probe  # noqa: E402
from repro.kernels.bloom_probe.ref import (  # noqa: E402
    bloom_probe_pairs_ref as jax_pairs_ref, bloom_probe_ref as jax_probe_ref,
    build_filter as jax_build_filter)
from repro.lsm import filters as ref_filters  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bloom_probe import bloom_probe as kernel  # noqa: E402
from repro_torch.kernels.bloom_probe import ops, ref  # noqa: E402
from repro_torch.lsm import filters  # noqa: E402


def _adversarial_keys(rng, n):
    keys = rng.integers(0, 2**63, n).astype(np.uint64)
    keys[0] = np.uint64(0)
    keys[1] = np.uint64(2**64 - 1)
    keys[2] = np.uint64(2**64 - 1)          # duplicate extreme
    keys[3:6] = keys[6]                     # duplicate run
    return keys


def _t32(a):
    """uint32 numpy -> int32 CPU tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np32(t):
    """int32 tensor -> uint32 numpy with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def _queries(rng, member):
    return np.concatenate([
        member[:512],
        np.array([0, 2**64 - 1, 2**64 - 1, 1], dtype=np.uint64),
        rng.integers(0, 2**64, 1532, dtype=np.uint64)])  # 2048: Pallas block


def _ragged_image(rng, sizes=(64, 300, 1000, 7), bits_per_key=10):
    """Several filters of different widths concatenated, as one LSM level
    image, plus every query x filter pair over it."""
    built, offs, cur = [], [], 0
    for n in sizes:
        keys = _adversarial_keys(rng, n) if n >= 7 else \
            rng.integers(0, 2**63, n).astype(np.uint64)
        nw, k = ref_filters.filter_params(n, bits_per_key)
        lo, hi = ref_filters.split_hash(keys)
        built.append((ref_filters.build_filter_np(lo, hi, nw, k), nw, keys))
        offs.append(cur)
        cur += nw
    image = np.concatenate([b for b, _, _ in built])
    queries = np.concatenate([built[1][2][:100],
                              rng.integers(0, 2**64, 400, dtype=np.uint64)])
    qlo, qhi = ref_filters.split_hash(queries)
    nf = len(built)
    p_lo, p_hi = np.tile(qlo, nf), np.tile(qhi, nf)
    p_off = np.repeat(np.array(offs, np.int64), len(queries))
    p_nw = np.repeat(np.array([nw for _, nw, _ in built], np.int64),
                     len(queries))
    return p_lo, p_hi, p_off, p_nw, image, k


# ----------------------------------------------------------------------
def test_hash_split_and_params_match_reference():
    rng = np.random.default_rng(0)
    keys = _adversarial_keys(rng, 2048)
    for a, b in zip(filters.split_hash(keys), ref_filters.split_hash(keys)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n, bpk in [(1, 1), (64, 10), (4096, 4), (10_000, 16)]:
        assert filters.filter_params(n, bpk) == \
            ref_filters.filter_params(n, bpk)


@pytest.mark.parametrize("bits_per_key,n", [(10, 1024), (4, 2048), (16, 512)])
def test_build_filter_matches_reference(bits_per_key, n):
    """Plain PyTorch build == jnp reference == numpy builders, bit for bit."""
    rng = np.random.default_rng(n)
    keys = _adversarial_keys(rng, n)
    nw, k = ref_filters.filter_params(n, bits_per_key)
    lo, hi = ref_filters.split_hash(keys)
    want = ref_filters.build_filter_np(lo, hi, nw, k)
    got_torch = _np32(ref.build_filter(_t32(lo), _t32(hi), nw, k))
    got_jax = np.asarray(jax_build_filter(jnp.array(lo), jnp.array(hi), nw,
                                          k_hashes=k))
    got_port_np = filters.build_filter_np(lo, hi, nw, k)
    assert np.array_equal(got_torch, want)
    assert np.array_equal(got_jax, want)
    assert np.array_equal(got_port_np, want)


@pytest.mark.parametrize("bits_per_key", [4, 10, 16])
def test_single_probe_matches_reference(bits_per_key):
    """Plain PyTorch probe == jnp reference == Pallas kernel (interpret)
    == numpy path, on adversarial members and random non-members."""
    rng = np.random.default_rng(3 + bits_per_key)
    member = _adversarial_keys(rng, 4096)
    nw, k = ref_filters.filter_params(len(member), bits_per_key)
    lo, hi = ref_filters.split_hash(member)
    bits = ref_filters.build_filter_np(lo, hi, nw, k)
    qlo, qhi = ref_filters.split_hash(_queries(rng, member))
    want = ref_filters.probe_np(qlo, qhi, bits, k)
    got_torch = ref.bloom_probe_ref(_t32(qlo), _t32(qhi), _t32(bits), k)
    got_jax = np.asarray(jax_probe_ref(jnp.array(qlo), jnp.array(qhi),
                                       jnp.array(bits), k_hashes=k))
    got_pallas = np.asarray(jax_probe(jnp.array(qlo), jnp.array(qhi),
                                      jnp.array(bits), k_hashes=k,
                                      interpret=True))
    assert got_torch.dtype == torch.int32
    assert np.array_equal(got_torch.numpy().astype(bool), want)
    assert np.array_equal(got_jax.astype(bool), want)
    assert np.array_equal(got_pallas.astype(bool), want)
    assert want[:512].all(), "a Bloom filter never gives false negatives"


def test_pairs_probe_matches_reference():
    """Ragged pairs over a multi-filter image: plain PyTorch == jnp
    reference == numpy pairs path == per-filter single probes."""
    rng = np.random.default_rng(11)
    p_lo, p_hi, p_off, p_nw, image, k = _ragged_image(rng)
    want = ref_filters.probe_pairs_np(p_lo, p_hi, p_off, p_nw, image, k)
    got_torch = ref.bloom_probe_pairs_ref(
        _t32(p_lo), _t32(p_hi), torch.from_numpy(p_off),
        torch.from_numpy(p_nw), _t32(image), k)
    got_jax = np.asarray(jax_pairs_ref(
        jnp.array(p_lo), jnp.array(p_hi), jnp.array(p_off.astype(np.int32)),
        jnp.array(p_nw.astype(np.uint32)), jnp.array(image), k_hashes=k))
    assert np.array_equal(got_torch.numpy().astype(bool), want)
    assert np.array_equal(got_jax.astype(bool), want)
    singles = np.concatenate([
        ref_filters.probe_np(p_lo[i:i + 1], p_hi[i:i + 1],
                             image[p_off[i]:p_off[i] + p_nw[i]], k)
        for i in range(0, len(p_lo), 97)])
    assert np.array_equal(want[::97], singles)


def test_ops_take_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    p_lo, p_hi, p_off, p_nw, image, k = _ragged_image(rng)
    before = dict(kernel.launches)
    got = ops.probe_pairs(_t32(p_lo), _t32(p_hi), torch.from_numpy(p_off),
                          torch.from_numpy(p_nw), _t32(image), k)
    want = ref_filters.probe_pairs_np(p_lo, p_hi, p_off, p_nw, image, k)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().astype(bool), want)
    first = image[:p_nw[0]]
    got1 = ops.probe(_t32(p_lo), _t32(p_hi), _t32(first), k)
    assert np.array_equal(got1.numpy().astype(bool),
                          ref_filters.probe_np(p_lo, p_hi, first, k))
    assert kernel.launches == before, "CPU tensors must not count launches"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: on CPU tensors they raise
    instead of computing anything."""
    lo = torch.zeros(4, dtype=torch.int32)
    bits = torch.ones(8, dtype=torch.int32)
    off = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.bloom_probe(lo, lo, bits, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.bloom_probe_pairs(lo, lo, off, off + 8, bits, 3)


def test_filters_torch_route_matches_numpy_route():
    rng = np.random.default_rng(9)
    p_lo, p_hi, p_off, p_nw, image, k = _ragged_image(rng)
    dev_image = filters.device_words(image, "cpu")
    assert dev_image.dtype == torch.int32
    a = filters.probe_pairs(p_lo, p_hi, p_off, p_nw, dev_image, k,
                            impl="torch")
    b = filters.probe_pairs(p_lo, p_hi, p_off, p_nw, image, k, impl="numpy")
    c = ref_filters.probe_pairs(p_lo, p_hi, p_off, p_nw, image, k,
                                impl="numpy")
    assert a.dtype == np.bool_ and np.array_equal(a, b)
    assert np.array_equal(a, c)
    first = image[:p_nw[0]]
    s_t = filters.probe(p_lo, p_hi, filters.device_words(first, "cpu"), k,
                        impl="torch")
    s_n = filters.probe(p_lo, p_hi, first, k, impl="numpy")
    assert np.array_equal(s_t, s_n)
    keys = np.concatenate([np.array([0, 2**64 - 1], np.uint64),
                           rng.integers(0, 2**64, 64, dtype=np.uint64)])
    assert [filters.probe_one_np(int(x), first, k) for x in keys] == \
        [ref_filters.probe_one_np(int(x), first, k) for x in keys]


def test_resolve_impl_routes():
    assert filters.resolve_impl("torch") == "torch"
    assert filters.resolve_impl("numpy") == "numpy"
    for bad in ("jax", "auto", "cuda"):
        with pytest.raises(ValueError):
            filters.resolve_impl(bad)


def test_from_reference_sst_arrays_copies_the_image():
    from repro.lsm.sstable import SST as RefSST
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 2**40, 300).astype(np.uint64))
    ref_sst = RefSST(sid=7, level=2, keys=keys,
                     tombs=np.zeros(len(keys), bool), obj_size=1024,
                     block_size=4096)
    ref_filters.attach_filter(ref_sst, 10)
    sst = filters.from_reference_sst_arrays(
        ref_sst.keys, ref_sst.tombs, ref_sst.filter_words, ref_sst.filter_k,
        sid=7, level=2)
    assert sst.filter_words is not ref_sst.filter_words
    assert np.array_equal(sst.filter_words, ref_sst.filter_words)
    assert (sst.sid, sst.level, sst.filter_k, sst.num_objs) == \
        (7, 2, ref_sst.filter_k, ref_sst.num_objs)
    filters.attach_filter(sst, 10)        # rebuilt by the port: same image
    assert np.array_equal(sst.filter_words, ref_sst.filter_words)


# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The CUDA device with the kernel built, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _build.nvcc_path()
    except RuntimeError as err:
        pytest.skip(str(err))
    kernel.load()
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain(card):
    """Both CUDA launchers equal their plain versions bit for bit."""
    rng = np.random.default_rng(13)
    member = _adversarial_keys(rng, 4096)
    nw, k = ref_filters.filter_params(len(member), 10)
    lo, hi = ref_filters.split_hash(member)
    bits = ref_filters.build_filter_np(lo, hi, nw, k)
    qlo, qhi = ref_filters.split_hash(_queries(rng, member))
    args = (_t32(qlo), _t32(qhi), _t32(bits))
    got = kernel.bloom_probe(*(a.to(card) for a in args), k)
    assert torch.equal(got.cpu(), ref.bloom_probe_ref(*args, k))
    p_lo, p_hi, p_off, p_nw, image, k = _ragged_image(rng)
    args = (_t32(p_lo), _t32(p_hi), torch.from_numpy(p_off),
            torch.from_numpy(p_nw.astype(np.int32)), _t32(image))
    got = kernel.bloom_probe_pairs(*(a.to(card) for a in args), k)
    assert torch.equal(got.cpu(), ref.bloom_probe_pairs_ref(*args, k))
