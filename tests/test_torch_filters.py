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
from repro.lsm.sstable import _mix64 as ref_mix64  # noqa: E402
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


def _i64(keys):
    """uint64 numpy keys -> int64 CPU tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                            .view(np.int64))


# (filter sizes in keys, extra slots' num_words pointing into the image,
# queries, pairs a query, the pairs' k: a fixed k or "mixed" over 1..16)
SLOT_CASES = {
    "several_slots_mixed_k": ((64, 300, 1000, 7), (), 400, 3, "mixed"),
    "k1_and_k16": ((300, 1000), (), 200, 2, (1, 16)),
    "one_word": ((1,), (), 64, 1, "mixed"),
    # num_words * 32 wraps uint32 to 96 bits: the reference's own wrap
    "num_words_wraps": ((300,), (2**27 + 3,), 200, 2, "mixed"),
    "no_pairs": ((64,), (), 5, 0, "mixed"),
}


def _slot_case(rng, sizes, extra_words, n_queries, per_query, ks):
    """The pairs form's operands: a store image of filters of ``sizes``
    keys (10 bits a key) plus slots of ``extra_words`` words at offset 0,
    and ``per_query`` pairs for each query (members of the second filter,
    0, 2**63, 2**64-1 and random keys), each on a random slot."""
    chunks, offs, nws, kk, cur, members = [], [], [], [], 0, []
    for n in sizes:
        keys = _adversarial_keys(rng, n) if n >= 7 else \
            rng.integers(0, 2**63, n).astype(np.uint64)
        nw, k = ref_filters.filter_params(n, 10)
        lo, hi = ref_filters.split_hash(keys)
        chunks.append(ref_filters.build_filter_np(lo, hi, nw, k))
        offs.append(cur)
        nws.append(nw)
        kk.append(k)
        members.append(keys)
        cur += nw
    for nw in extra_words:
        offs.append(0)
        nws.append(nw)
        kk.append(7)
    words = np.concatenate(chunks)
    queries = np.concatenate([
        members[min(1, len(members) - 1)][:n_queries // 4],
        np.array([0, 2**63, 2**63 + 1, 2**64 - 1], np.uint64),
        rng.integers(0, 2**64, n_queries, dtype=np.uint64)])[:n_queries]
    p = n_queries * per_query
    pair_key = rng.integers(0, n_queries, p).astype(np.int32)
    if p:
        pair_key[-1] = n_queries - 1
    pair_slot = rng.integers(0, len(offs), p).astype(np.int32)
    if ks == "mixed":
        pair_k = rng.integers(1, 17, p).astype(np.uint8)
    else:
        pair_k = np.array(ks, np.uint8)[rng.integers(0, len(ks), p)]
    return (queries, pair_key, pair_slot, pair_k,
            np.array(offs, np.int64), np.array(nws, np.int32), words)


def _pairs_by_jax(keys, pair_key, pair_slot, pair_k, slot_off, slot_words,
                  words):
    """The JAX package's pairs reference on the same pairs: keys hashed
    on its side, slots expanded to (word_off, num_words), one call per
    distinct k."""
    lo, hi = ref_filters.split_hash(keys)
    lo, hi = lo[pair_key], hi[pair_key]
    off = slot_off[pair_slot].astype(np.int32)
    nw = slot_words[pair_slot].astype(np.uint32)
    out = np.zeros(len(pair_key), bool)
    for k in np.unique(pair_k):
        m = pair_k == k
        out[m] = np.asarray(jax_pairs_ref(
            jnp.array(lo[m]), jnp.array(hi[m]), jnp.array(off[m]),
            jnp.array(nw[m]), jnp.array(words), k_hashes=int(k))).astype(bool)
    return out


def _slot_tensors(case):
    keys, pair_key, pair_slot, pair_k, slot_off, slot_words, words = case
    return (_i64(keys), torch.from_numpy(pair_key),
            torch.from_numpy(pair_slot), torch.from_numpy(pair_k),
            torch.from_numpy(slot_off), torch.from_numpy(slot_words),
            _t32(words))


# ----------------------------------------------------------------------
def test_hash_split_and_params_match_reference():
    rng = np.random.default_rng(0)
    keys = _adversarial_keys(rng, 2048)
    for a, b in zip(filters.split_hash(keys), ref_filters.split_hash(keys)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n, bpk in [(1, 1), (64, 10), (4096, 4), (10_000, 16)]:
        assert filters.filter_params(n, bpk) == \
            ref_filters.filter_params(n, bpk)


def test_plain_mix64_matches_reference():
    """splitmix64 in int64 torch arithmetic == the JAX package's
    ``_mix64`` and ``split_hash``, bit for bit, on keys across the whole
    uint64 range (0, 2**63 and up, 2**64-1)."""
    rng = np.random.default_rng(21)
    keys = np.concatenate([
        np.array([0, 1, 2**31, 2**32, 2**63 - 1, 2**63, 2**63 + 1,
                  2**64 - 2, 2**64 - 1], np.uint64),
        rng.integers(0, 2**64, 4096, dtype=np.uint64),
        rng.integers(2**63, 2**64, 1024, dtype=np.uint64)])
    got = ref.mix64(_i64(keys)).numpy().view(np.uint64)
    assert np.array_equal(got, ref_mix64(keys))
    lo, hi = ref.split_hash(_i64(keys))
    want_lo, want_hi = ref_filters.split_hash(keys)
    assert np.array_equal(lo.numpy(), want_lo.astype(np.int64))
    assert np.array_equal(hi.numpy(), want_hi.astype(np.int64))


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


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_pairs_probe_matches_reference(case):
    """The pairs form (keys hashed inside, a slot and a k a pair): plain
    PyTorch == the JAX package's jnp pairs reference (grouped by k) ==
    the numpy twin == the JAX package's numpy pairs path == per-filter
    single probes."""
    rng = np.random.default_rng(11)
    args = _slot_case(rng, *SLOT_CASES[case])
    keys, pair_key, pair_slot, pair_k, slot_off, slot_words, words = args
    want = _pairs_by_jax(*args)
    got_torch = ref.bloom_probe_pairs_ref(*_slot_tensors(args))
    assert got_torch.dtype == torch.uint8
    assert got_torch.shape == (len(pair_key),)
    assert np.array_equal(got_torch.numpy().astype(bool), want)
    assert np.array_equal(filters.probe_slots_np(*args), want)
    lo, hi = ref_filters.split_hash(keys)
    for k in np.unique(pair_k):
        m = pair_k == k
        assert np.array_equal(ref_filters.probe_pairs_np(
            lo[pair_key[m]], hi[pair_key[m]], slot_off[pair_slot[m]],
            slot_words[pair_slot[m]], words, int(k)), want[m])
    for p in range(0, len(pair_key), 37):
        s_, k = pair_slot[p], int(pair_k[p])
        if slot_words[s_] < 2**27:
            bits = words[slot_off[s_]:slot_off[s_] + slot_words[s_]]
            one = ref_filters.probe_np(lo[pair_key[p]:pair_key[p] + 1],
                                       hi[pair_key[p]:pair_key[p] + 1],
                                       bits, k)
            assert one[0] == want[p]
    if case == "several_slots_mixed_k":
        assert want.any() and not want.all()


def test_ops_take_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(5)
    args = _slot_case(rng, *SLOT_CASES["several_slots_mixed_k"])
    before = dict(kernel.launches)
    got = ops.probe_pairs(*_slot_tensors(args))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().astype(bool),
                          filters.probe_slots_np(*args))
    keys, slot_off, slot_words, words = args[0], args[4], args[5], args[6]
    lo, hi = ref_filters.split_hash(keys)
    first = words[:slot_words[0]]
    got1 = ops.probe(_t32(lo), _t32(hi), _t32(first), 7)
    assert got1.dtype == torch.int32
    assert np.array_equal(got1.numpy().astype(bool),
                          ref_filters.probe_np(lo, hi, first, 7))
    assert kernel.launches == before, "CPU tensors must not count launches"


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers and the resident image take CUDA tensors only: on
    CPU tensors they raise instead of computing anything."""
    lo = torch.zeros(4, dtype=torch.int32)
    bits = torch.ones(8, dtype=torch.int32)
    keys = torch.zeros(4, dtype=torch.int64)
    off = torch.zeros(2, dtype=torch.int64)
    nw = torch.full((2,), 4, dtype=torch.int32)
    pk = torch.zeros(4, dtype=torch.uint8) + 3
    with pytest.raises(ValueError, match="CUDA"):
        kernel.bloom_probe(lo, lo, bits, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.bloom_probe_pairs(keys, lo, lo, pk, off, nw, bits)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.Image(bits, off, nw)
    before = dict(kernel.launches)
    image = filters.StoreImage([bits], [(1, 0, 4, 3), (2, 4, 4, 3)],
                               torch.device("cpu"))
    assert image.resident is None and image.tensors is not None
    assert kernel.launches == before


@pytest.mark.parametrize("case", ["several_slots_mixed_k", "one_word",
                                  "no_pairs"])
def test_filters_torch_route_matches_numpy_route(case):
    """A store image and prober on the torch route (CPU tensors) and on
    the numpy route give the same hits as the JAX package's numpy path,
    in the pairs form and the single-filter form."""
    rng = np.random.default_rng(9)
    args = _slot_case(rng, *SLOT_CASES[case])
    keys, pair_key, pair_slot, pair_k, slot_off, slot_words, words = args
    entries = [(100 + s_, int(o), int(nw), int(k)) for s_, (o, nw, k) in
               enumerate(zip(slot_off, slot_words, [7] * len(slot_off)))]
    by_route = {"numpy": filters.StoreImage([words], entries),
                "torch": filters.StoreImage(
                    [filters.device_words(words, "cpu")], entries,
                    torch.device("cpu"))}
    assert by_route["torch"].words.dtype == torch.int32
    prober = filters.Prober()
    want = _pairs_by_jax(*args)
    lo, hi = ref_filters.split_hash(keys)
    for image in by_route.values():
        assert image.slot == {100 + s_: s_ for s_ in range(len(entries))}
        got = prober.probe_pairs(image, keys, pair_key, pair_slot, pair_k)
        assert got.dtype == np.bool_ and np.array_equal(got, want)
        single = prober.probe(image, 0, lo, hi, 7)
        assert np.array_equal(single, ref_filters.probe_np(
            lo, hi, words[:slot_words[0]], 7))
    first = words[:slot_words[0]]
    assert [filters.probe_one_np(int(x), first, 7) for x in keys] == \
        [ref_filters.probe_one_np(int(x), first, 7) for x in keys]


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
    for case in ("several_slots_mixed_k", "k1_and_k16", "one_word",
                 "no_pairs"):
        args = _slot_tensors(_slot_case(rng, *SLOT_CASES[case]))
        got = kernel.bloom_probe_pairs(*(a.to(card) for a in args))
        assert torch.equal(got.cpu(), ref.bloom_probe_pairs_ref(*args))
