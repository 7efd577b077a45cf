"""The port's paper apps against the reference's, on the CPU.

The bitsets, BitFunnel, masked-init and bitmap-index workloads of
``tests/test_apps.py``, ``ambit_scan_stats`` and the TMR codec run on the
port's "torch" backend (the twin of the reference's "jnp") and on
"ambit_sim" in both packages, with the same numpy-seeded inputs: the bits,
counts and every ``last_stats`` field must be equal, and the answers must
match plain numpy.
"""

import dataclasses

import numpy as np
import pytest

from repro.apps import bitfunnel as jbf
from repro.apps import bitmap_index as jbi
from repro.apps import bitsets as jbs
from repro.apps import bitweaving_db as jbw
from repro.apps import masked_init as jmi
from repro.core import BitVector as JBitVector
from repro.core import BulkBitwiseEngine as JEngine
from repro.core.ecc import TMRCodec as JTMRCodec
from repro_torch.apps import bitfunnel, bitmap_index, bitsets, bitweaving_db
from repro_torch.apps import masked_init
from repro_torch.convert import to_numpy_u32
from repro_torch.core import BitVector, BulkBitwiseEngine
from repro_torch.core.ecc import TMRCodec
from repro_torch.pim import AmbitRuntime

PAIRS = [("jnp", "torch"), ("ambit_sim", "ambit_sim")]
CPU = "cpu"


def engines(ref_backend, backend):
    return JEngine(ref_backend), BulkBitwiseEngine(backend, device=CPU)


def same_bv(port, ref):
    assert port.n_bits == ref.n_bits
    np.testing.assert_array_equal(to_numpy_u32(port.data),
                                  np.asarray(ref.data))


def same_stats(eng, jeng):
    assert dataclasses.astuple(eng.last_stats) == \
        dataclasses.astuple(jeng.last_stats)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_bitsets_match_reference(ref_backend, backend):
    rng = np.random.default_rng(0)
    domain = 2048
    jeng, eng = engines(ref_backend, backend)
    jops, ops = jbs.BitSetOps(domain, jeng), bitsets.BitSetOps(domain, eng)
    arrs = [np.sort(rng.choice(domain, 200, replace=False))
            for _ in range(4)]
    sets, jsets = [ops.make(a) for a in arrs], [jops.make(a) for a in arrs]
    assert all(s.data.device.type == CPU for s in sets)
    for name, args in (("union", ()), ("intersection", ()),
                       ("difference", ("base",))):
        if args:
            got = ops.difference(sets[0], sets[1:])
            want = jops.difference(jsets[0], jsets[1:])
            oracle = bitsets.SortedSetOps.difference(arrs[0], arrs[1:])
        else:
            got, want = getattr(ops, name)(sets), getattr(jops, name)(jsets)
            oracle = getattr(bitsets.SortedSetOps, name)(arrs)
        same_bv(got, want)
        same_stats(eng, jeng)
        np.testing.assert_array_equal(np.nonzero(got.bits().numpy())[0],
                                      oracle)
    np.testing.assert_array_equal(
        bitsets.SortedSetOps.union(arrs), jbs.SortedSetOps.union(arrs))


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_masked_init_matches_reference(ref_backend, backend):
    rng = np.random.default_rng(1)
    jeng, eng = engines(ref_backend, backend)
    xb, mb = (rng.integers(0, 2, (2, 1000)).astype(bool) for _ in range(2))
    x, m = (BitVector.from_bits(b, device="cpu") for b in (xb, mb))
    jx, jm = JBitVector.from_bits(xb), JBitVector.from_bits(mb)
    for fn, oracle in (("masked_set", xb | mb), ("masked_clear", xb & ~mb),
                       ("clear_color_channel", xb & ~mb)):
        got = getattr(masked_init, fn)(eng, x, m)
        same_bv(got, getattr(jmi, fn)(jeng, jx, jm))
        same_stats(eng, jeng)
        np.testing.assert_array_equal(got.bits().numpy(), oracle)


DOCS = {0: ["apple", "banana"], 1: ["banana", "cherry"],
        2: ["apple", "cherry", "date"], 3: ["elderberry"]}
QUERIES = (["apple"], ["banana"], ["apple", "cherry"], ["fig"],
           ["date", "elderberry"])


def _filled(index):
    for d, terms in DOCS.items():
        index.add_document(d, terms)
    return index


@pytest.mark.parametrize("path", ["default", "ambit_sim", "runtime"])
def test_bitfunnel_matches_reference(path):
    """The default engine ("torch" here, "jnp" there), the DRAM model,
    and the resident path (the port's runtime on "torch" against the
    reference's on "jnp"): the same candidates, and no false negatives."""
    kw, jkw = {}, {}
    if path == "ambit_sim":
        kw = {"engine": BulkBitwiseEngine("ambit_sim", device=CPU)}
        jkw = {"engine": JEngine("ambit_sim")}
    elif path == "runtime":
        from repro.pim import AmbitRuntime as JRuntime
        kw = {"runtime": AmbitRuntime(backend="torch", device=CPU)}
        jkw = {"runtime": JRuntime(backend="jnp")}
    idx = _filled(bitfunnel.BitFunnelIndex(n_docs=4, filter_bits=256,
                                           device=CPU, **kw))
    jidx = _filled(jbf.BitFunnelIndex(n_docs=4, filter_bits=256, **jkw))
    if path == "default":
        assert idx.engine.backend == "torch"
        assert idx.engine.device.type == CPU
    for terms in QUERIES:
        got = idx.query(terms)
        np.testing.assert_array_equal(got, jidx.query(terms))
        must = set.intersection(*(
            {d for d, ts in DOCS.items() if t in ts} for t in terms))
        assert must <= set(got.tolist())
    assert bitfunnel._hashes("apple", 3, 256) == \
        jbf._hashes("apple", 3, 256)


def test_bitfunnel_resident_lifecycle_matches_reference():
    from repro.pim import AmbitRuntime as JRuntime
    rt, jrt = AmbitRuntime(backend="torch", device=CPU), \
        JRuntime(backend="jnp")
    idx = _filled(bitfunnel.BitFunnelIndex(6, 128, runtime=rt))
    jidx = _filled(jbf.BitFunnelIndex(6, 128, runtime=jrt))
    for i in (idx, jidx):
        i.freeze(pin=True)
    assert sorted(idx._resident) == sorted(jidx._resident)
    idx.add_document(5, ["fig"])         # a mutation thaws the filter
    jidx.add_document(5, ["fig"])
    assert not idx._resident and not jidx._resident
    for terms in QUERIES:
        np.testing.assert_array_equal(idx.query(terms), jidx.query(terms))
    with pytest.raises(ValueError, match="freeze"):
        bitfunnel.BitFunnelIndex(4, device=CPU).freeze()


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_bitmap_index_matches_reference(ref_backend, backend):
    rng = np.random.default_rng(0)
    n = 3000
    jeng, eng = engines(ref_backend, backend)
    idx, jidx = bitmap_index.BitmapIndex(n, eng), jbi.BitmapIndex(n, jeng)
    weeks = {}
    for w in range(3):
        members = rng.choice(n, n // 3, replace=False)
        weeks[f"w{w}"] = set(members.tolist())
        idx.add(f"w{w}", members)
        jidx.add(f"w{w}", members)
    male = rng.choice(n, n // 2, replace=False)
    idx.add("male", male)
    jidx.add("male", male)
    uniq, per_week, stats = idx.weekly_active_query(list(weeks), "male")
    juniq, jper_week, jstats = jidx.weekly_active_query(list(weeks), "male")
    assert (uniq, per_week) == (juniq, jper_week)
    assert dataclasses.astuple(stats) == dataclasses.astuple(jstats)
    assert uniq == len(set.intersection(*weeks.values()))
    male_set = set(male.tolist())
    assert per_week == [len(weeks[w] & male_set) for w in weeks]
    if backend == "ambit_sim":
        assert stats.ns > 0 and stats.energy_nj > 0


@pytest.mark.parametrize("bits", [1, 7, 10])
def test_ambit_scan_stats_matches_reference(bits):
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 2**bits, 5000).astype(np.uint32)
    col = bitweaving_db.BitWeavingColumn.from_values(vals, bits, device=CPU)
    jcol = jbw.BitWeavingColumn.from_values(vals, bits)
    eng, jeng = BulkBitwiseEngine("ambit_sim", device=CPU), \
        JEngine("ambit_sim")
    top = (1 << bits) - 1
    for c1, c2 in ((0, top), (top, top), (1, top // 2), (top // 3, top)):
        got = bitweaving_db.ambit_scan_stats(col, c1, c2, eng)
        assert got == jbw.ambit_scan_stats(jcol, c1, c2, jeng)
        if c1 > 0:      # the padding rows hold 0: below any c1 > 0
            assert got[0] == col.oracle_count(vals, c1, c2)
    big = bitweaving_db.BitWeavingColumn.from_values(
        np.zeros(70_000, np.uint32), 4, device=CPU)
    jbig = jbw.BitWeavingColumn.from_values(np.zeros(70_000, np.uint32), 4)
    assert bitweaving_db.ambit_scan_stats(big, 1, 3, eng) == \
        jbw.ambit_scan_stats(jbig, 1, 3, jeng)


@pytest.mark.parametrize("ref_backend,backend", PAIRS)
def test_tmr_codec_matches_reference(ref_backend, backend):
    """Encode, replica-wise ops, a flipped replica, the majority decode
    (one TRA on the DRAM model) and the scrub's count of corrected bits."""
    rng = np.random.default_rng(4)
    jeng, eng = engines(ref_backend, backend)
    codec, jcodec = TMRCodec(eng), JTMRCodec(jeng)
    xb, yb = (rng.integers(0, 2, 300).astype(bool) for _ in range(2))
    x, y = codec.encode(BitVector.from_bits(xb, device="cpu")), \
        codec.encode(BitVector.from_bits(yb, device="cpu"))
    jx, jy = jcodec.encode(JBitVector.from_bits(xb)), \
        jcodec.encode(JBitVector.from_bits(yb))
    # every replica owns its storage: a flip in one reaches no other
    assert len({r.data.data_ptr() for r in x}) == 3
    flip = rng.choice(300, 9, replace=False)
    bad = xb.copy()
    bad[flip] ^= True
    x[1] = BitVector.from_bits(bad, device="cpu")
    jx[1] = JBitVector.from_bits(bad)
    z, jz = codec.apply("xor", x, y), jcodec.apply("xor", jx, jy)
    for r, jr in zip(z, jz):
        same_bv(r, jr)
    nz, jnz = codec.apply1("not_", z), jcodec.apply1("not_", jz)
    same_bv(codec.decode(nz), jcodec.decode(jnz))
    same_stats(eng, jeng)
    np.testing.assert_array_equal(codec.decode(nz).bits().numpy(),
                                  ~(xb ^ yb))
    clean, corrected = codec.scrub(x)
    jclean, jcorrected = jcodec.scrub(jx)
    assert corrected == jcorrected == 9
    for r, jr in zip(clean, jclean):
        same_bv(r, jr)
    assert codec.storage_overhead() == jcodec.storage_overhead()
