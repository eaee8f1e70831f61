"""Parity of the port's host layers with the JAX reference: the machine
descriptions, the Hopper tuner, the tune cache and its JSON schema.

The copies must agree with the originals exactly (same constants, same
measured pad factors, same cache keys and documents); the Hopper tuner
ranks layouts by measured pad factor and differs from the TPU tuner's
budget where the budget differs — the RHS tile.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.core.autotune as ref_autotune
import repro_torch.core.autotune as autotune
from repro.core import sdv as ref_sdv
from repro.core.jsonstore import SchemaVersionError as RefSchemaVersionError
from repro.service import tunecache as ref_tc
from repro.sparse import formats as RF
from repro_torch.core import sdv
from repro_torch.service import tunecache as tc
from repro_torch.sparse import formats as F


def _lengths(seed, n=3000, skew=1.0, avg=9.0):
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(np.log(avg) - skew ** 2 / 2, skew, n)
    return np.clip(np.round(raw).astype(np.int64), 1, n)


# ---------------------------------------------------------------------------
# Machine descriptions
# ---------------------------------------------------------------------------


def test_machine_params_fields_and_tags_match_reference():
    assert [f.name for f in dataclasses.fields(sdv.MachineParams)] == \
        [f.name for f in dataclasses.fields(ref_sdv.MachineParams)]
    for port_m, ref_m in ((sdv.tpu_v5e_machine(), ref_sdv.tpu_v5e_machine()),
                          (sdv.MachineParams(), ref_sdv.fpga_sdv_machine())):
        assert dataclasses.asdict(port_m) == dataclasses.asdict(ref_m)
        assert tc.machine_tag(port_m) == ref_tc.machine_tag(ref_m)


def test_h100_machine_constants_are_the_data_sheet():
    m = sdv.h100_machine()
    assert m.name == "h100-sxm" and m.lanes == 32 and m.line_bytes == 128
    assert m.l2_bytes == 50_000_000
    # 3.35 TB/s at the 1,980 MHz boost clock
    assert abs(m.peak_bw_bytes_per_cycle * m.freq_mhz * 1e6 - 3.35e12) < 1e10
    assert m.bw_limit_bytes_per_cycle == m.peak_bw_bytes_per_cycle
    assert sdv.h100_machine(base_mem_latency=900).base_mem_latency == 900


# ---------------------------------------------------------------------------
# Tuner: the reference's pad factors, ranked directly; Hopper budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,sigma", [(8, 8), (32, 256), (128, 128), (256, 4096)])
def test_measured_pad_factor_matches_reference(c, sigma):
    lengths = _lengths(c)
    assert autotune.measured_pad_factor(lengths, c, sigma) == \
        ref_autotune.measured_pad_factor(lengths, c, sigma)


@pytest.mark.parametrize("seed,cands", [
    (1, [8, 16, 32, 64, 128]), (2, [32, 64]), (3, [32, 256, 1024]),
    (4, [8]), (5, [16, 512])])
def test_tuner_table_measures_the_reference_pad_factors(seed, cands):
    """The port sweeps the reference's (C, sigma) grid, measures the same
    pad factors, and keeps the least as its choice and its score."""
    lengths = _lengths(seed)
    got = autotune.tune_sell_layout(lengths, candidates_c=cands)
    want = ref_autotune.tune_sell_layout(lengths, n_cols=3000,
                                         candidates_c=cands)
    assert [r[:3] for r in got.table] == [r[:3] for r in want.table]
    best = min(got.table, key=lambda r: r[2])
    assert (got.c, got.sigma, got.pad_factor, got.cycles) == \
        (best[0], best[1], best[2], best[2])


def test_hopper_tuner_prefers_warp_multiples():
    r = autotune.tune_sell_layout(_lengths(2))
    assert {c for c, *_ in r.table} == {32, 64, 128, 256, 512, 1024}
    assert r.c % autotune.WARP == 0
    tiny = autotune.tune_sell_layout(np.array([3, 1, 4, 1, 5]))
    assert tiny.c == 8                    # fewer rows than a warp


def test_pick_k_block_prices_registers_not_x_residency():
    assert autotune.pick_k_block() == 32                 # fp64
    assert autotune.pick_k_block(elem_bytes=4) == 32     # template cap
    assert autotune.pick_k_block(k_max=8) == 8
    for eb in (4, 8):
        k = autotune.pick_k_block(elem_bytes=eb)
        assert k * eb <= autotune.ACC_BYTES_PER_THREAD


def test_million_column_operand_keeps_its_rhs_tile():
    """The finding behind the Hopper budget: on a 2M-column operand the TPU
    tuner drops to k_block=1 (X fails VMEM residency), the port keeps 32."""
    lengths = _lengths(3, n=4096, avg=16.0)
    n_cols = 2_097_152
    ref = ref_autotune.tune_sell_layout(lengths, n_cols=n_cols,
                                        candidates_c=[32, 64])
    port = autotune.tune_sell_layout(lengths, candidates_c=[32, 64])
    assert ref.k_block == 1
    assert port.k_block == 32


def test_budget_constants():
    assert autotune.SPMM_BLOCK_THREADS % autotune.WARP == 0
    assert autotune.MAX_K_TILE == 32


# ---------------------------------------------------------------------------
# Tune cache: same keys, same documents, both directions
# ---------------------------------------------------------------------------


def _pair_csr(seed=0):
    ref = RF.random_csr(150, 140, 5.0, seed=seed, skew=1.0)
    port = F.CSRMatrix(indptr=ref.indptr, indices=ref.indices, data=ref.data,
                       n_cols=ref.n_cols)
    return ref, port


def test_operand_signatures_and_keys_match_reference():
    ref, port = _pair_csr()
    assert tc.operand_signature(port).key == ref_tc.operand_signature(ref).key
    assert tc.operand_signature(F.csr_to_sell_slabs(port, c=16)).key == \
        ref_tc.operand_signature(RF.csr_to_sell_slabs(ref, c=16)).key
    assert tc.operand_signature(F.csr_to_sell(port, c=16)).key == \
        ref_tc.operand_signature(RF.csr_to_sell(ref, c=16)).key
    assert tc.TuneCache.sell_key(
        "spmv", port, device="cpu", dtype="float64",
        machine=sdv.tpu_v5e_machine()) == ref_tc.TuneCache.sell_key(
        "spmv", ref, device="cpu", dtype="float64",
        machine=ref_sdv.tpu_v5e_machine())
    with pytest.raises(TypeError, match="unsupported operand"):
        tc.operand_signature(object())


def test_reference_written_cache_loads_in_the_port_and_back(tmp_path):
    path = str(tmp_path / "tunes.json")
    ref_csr, port_csr = _pair_csr(4)
    ref_cache = ref_tc.TuneCache(path)
    key = ref_cache.sell_key("spmv", ref_csr, device="cpu",
                             machine=ref_sdv.tpu_v5e_machine())
    tuned = ref_autotune.tune_sell_layout(ref_csr.row_lengths, n_cols=140)
    ref_cache.put_sell(key, tuned)
    ref_cache.note_repack("repack|x|c8|sigma64")
    ref_cache.set_hint("spmv", "tpu-v5e", 64)
    ref_cache.save()

    port_cache = tc.TuneCache(path)
    got = port_cache.get_sell(key)
    assert dataclasses.asdict(got) == dataclasses.asdict(tuned)
    assert port_cache.repacks == {"repack|x|c8|sigma64": 1}
    assert port_cache.hint_vl("spmv", "tpu-v5e") == 64
    # the port writes the same document back; the reference reads it
    port_cache.put_sell("spmv|port-key", autotune.tune_sell_layout(
        port_csr.row_lengths))
    port_cache.save()
    again = ref_tc.TuneCache(path)
    assert again.get_sell("spmv|port-key").k_block == 32
    doc = json.loads((tmp_path / "tunes.json").read_text())
    assert doc["schema_version"] == tc.SCHEMA_VERSION == ref_tc.SCHEMA_VERSION


def test_future_schema_is_refused_like_the_reference(tmp_path):
    path = tmp_path / "future.json"
    path.write_text(json.dumps({"schema_version": 99, "entries": {}}))
    with pytest.raises(RefSchemaVersionError):
        ref_tc.TuneCache(str(path))
    with pytest.raises(tc.SchemaVersionError, match="newer version"):
        tc.TuneCache(str(path))
    with pytest.warns(RuntimeWarning, match="ignoring the stale store"):
        assert tc.TuneCache(str(path), strict=False).stats["entries"] == 0
