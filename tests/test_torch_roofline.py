"""The port's config counters, ``roofline/analysis.py`` and the dry run's
per-rank count (``launch/dryrun.py``) against the reference.

* Every counter of ``repro_torch.config`` (``param_count``,
  ``active_param_count``, ``kv_bytes_per_token_fullkv``,
  ``attention_free``, ``num_attention_layers``, ThinKV's
  ``max_blocks_per_seq_factor`` and ``avg_bits``, the input shapes,
  ``config_to_dict``) equals the reference's for every registered config
  and its smoke form: integers exactly, floats within 1e-12.
* ``model_flops_for`` and ``attention_flops_for`` equal the reference's
  for every (config x shape x variant); ``RooflineTerms``' three times are
  the reference's scaled by the ratio of the peaks (H100 SXM against TPU
  v5e), as ``tests/test_roofline.py::test_terms_arithmetic`` builds them.
* The dry run counts every cell of mistral-large-123b at the multi-pod
  mesh on the ``meta`` device in seconds, and the bytes per rank add up
  from the blocks.
"""
import dataclasses
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import repro.config as RC  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.roofline import analysis as RJ  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402

FORMS = [(a, f) for a in ARCHS for f in ("full", "smoke")]
VARIANTS = ("train", "prefill", "decode_fullkv", "decode_thinkv")
MIXES = ((0.15, 0.45, 0.40), (1.0, 0.0, 0.0), (0.2, 0.3, 0.5))


def pair(arch, form):
    if form == "full":
        return jax_config(arch), get_config(arch)
    return jax_smoke(arch), get_smoke_config(arch)


def plain(d):
    """A ``config_to_dict`` with enum members as their values."""
    if isinstance(d, dict):
        return {k: plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [plain(v) for v in d]
    return getattr(d, "value", d)


@pytest.mark.parametrize("arch,form", FORMS,
                         ids=[f"{a}-{f}" for a, f in FORMS])
def test_config_counters_equal_the_references(arch, form):
    j, t = pair(arch, form)
    for name in ("param_count", "active_param_count",
                 "kv_bytes_per_token_fullkv", "num_attention_layers"):
        got, want = getattr(t, name)(), getattr(j, name)()
        assert type(got) is int and got == want, (name, got, want)
    assert t.attention_free == j.attention_free
    jt, tt = RC.ThinKVConfig(), TC.ThinKVConfig()
    assert tt.max_blocks_per_seq_factor == jt.max_blocks_per_seq_factor
    for mix in MIXES:
        assert tt.avg_bits(mix) == pytest.approx(jt.avg_bits(mix), abs=1e-12)
    assert tt.avg_bits() == pytest.approx(jt.avg_bits(), abs=1e-12)
    for prec in ((2, 4, 8), (4, 4, 4)):
        a = dataclasses.replace(tt, precision=prec)
        b = dataclasses.replace(jt, precision=prec)
        assert a.avg_bits() == pytest.approx(b.avg_bits(), abs=1e-12)
    assert [dataclasses.astuple(s) for s in TC.shape_cells(t)] == \
        [dataclasses.astuple(s) for s in RC.shape_cells(j)]
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    # the port keeps every field but the reference's dtype
    want = plain(RC.config_to_dict(j))
    assert want.pop("dtype") == "bfloat16"
    assert plain(TC.config_to_dict(t)) == want
    assert plain(TC.config_to_dict(tt)) == plain(RC.config_to_dict(jt))


@pytest.mark.parametrize("arch", ARCHS)
def test_flop_counts_equal_the_references(arch):
    """Every shape and variant, full and smoke."""
    for form in ("full", "smoke"):
        j, t = pair(arch, form)
        for name, shape in RC.SHAPES.items():
            tshape = TC.SHAPES[name]
            for v in VARIANTS:
                assert RA.model_flops_for(t, tshape, v) == \
                    RJ.model_flops_for(j, shape, v), (name, v)
                assert RA.attention_flops_for(t, tshape, v) == \
                    RJ.attention_flops_for(j, shape, v), (name, v)


def test_terms_are_the_references_scaled_by_the_peaks():
    """The reference's ``test_terms_arithmetic`` inputs: each time is the
    reference's times its peak over the H100's; the ratios that do not
    depend on the hardware stay equal."""
    kw = dict(arch="x", shape="train_4k", variant="train", mesh="single",
              chips=256, flops_per_device=197e12, bytes_per_device=819e9,
              collective_bytes_per_device=50e9,
              model_flops=256 * 197e12 / 2)
    j, t = RJ.RooflineTerms(**kw), RA.RooflineTerms(**kw)
    assert t.t_compute == pytest.approx(j.t_compute * RJ.PEAK_FLOPS
                                        / RA.PEAK_FLOPS, rel=1e-12)
    assert t.t_memory == pytest.approx(j.t_memory * RJ.HBM_BW / RA.HBM_BW,
                                       rel=1e-12)
    assert t.t_collective == pytest.approx(j.t_collective * RJ.ICI_BW
                                           / RA.LINK_BW, rel=1e-12)
    assert t.useful_flops_ratio == pytest.approx(j.useful_flops_ratio)
    assert t.t_compute == pytest.approx(197e12 / 67e12)
    assert t.bottleneck == "collective"          # gloo through the host
    d = t.to_dict()
    assert d["t_memory"] == t.t_memory and d["bottleneck"] == t.bottleneck
    assert (RA.F32_FLOPS, RA.F64_TC_FLOPS, RA.HBM_BW) == \
        (67e12, 67e12, 3.35e12)
    assert RA.PEAKS["f32"][0] == RA.PEAK_FLOPS == RA.F32_FLOPS


def test_variants_follow_the_reference():
    assert DR.variants_for("r1-llama-8b", "train_4k") == ["train"]
    assert DR.variants_for("r1-llama-8b", "decode_32k") == \
        ["decode_fullkv", "decode_thinkv"]
    assert DR.variants_for("falcon-mamba-7b", "long_500k") == \
        ["decode_fullkv"]
    assert DR.variants_for("zamba2-7b", "long_500k") == \
        ["decode_fullkv", "decode_thinkv"]
    assert DR.variants_for("mixtral-8x7b", "long_500k") == ["decode_thinkv"]


def test_dry_run_counts_mistral_large_at_the_multi_pod_mesh(tmp_path):
    """Every cell of mistral-large-123b (123 G parameters, 492 GB in f32)
    on (pod 2, data 16, model 16), on the meta device, in seconds."""
    t0 = time.perf_counter()
    assert DR.main(["--arch", "mistral-large-123b", "--mesh", "multi",
                    "--out", str(tmp_path)]) == 0
    assert time.perf_counter() - t0 < 60
    files = sorted(os.listdir(tmp_path))
    want = [f"mistral-large-123b__{s}__{v}__multi.json"
            for s in RC.SHAPES for v in DR.variants_for(
                "mistral-large-123b", s)]
    assert files == sorted(want)
    cfg = get_config("mistral-large-123b")
    for f in files:
        rec = json.loads((tmp_path / f).read_text())
        assert rec["status"] == "ok" and rec["all_meta"], f
        assert rec["chips"] == 512
        # FSDP over 32 x TP over 16 (train) or TP over 16 (serve)
        whole = 4 * cfg.param_count()
        n = 512 if rec["param_mode"] == "train" else 16
        assert whole / n <= rec["param_bytes_per_rank"] < whole / n * 1.2
        terms = rec["roofline"]
        assert terms["flops_per_device"] == pytest.approx(
            (RA.model_flops_for(cfg, TC.SHAPES[rec["shape"]], rec["variant"])
             + RA.attention_flops_for(cfg, TC.SHAPES[rec["shape"]],
                                      rec["variant"])) / 512)
        if rec["variant"] == "train":
            assert rec["opt_state_bytes_per_rank"] == \
                2 * rec["param_bytes_per_rank"]
            coll = rec["collectives"]
            assert not any(k.startswith("all_gather/model/param")
                           for k in coll), coll
            assert coll["all_gather/dp/param"] > 0
            assert coll["all_reduce/model/act"] > 0
