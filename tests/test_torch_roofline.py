"""The port's roofline model (``repro_torch.launch.roofline``) against the JAX
package's: for every config of ``ARCHS`` and every shape that applies, the
analytic FLOPs and bytes equal the reference's to a relative 1e-12, and the
three terms differ only by the ratio of the peaks (the H100 SXM's against
the reference's). Then ``tests/test_roofline.py``'s five cases on the
port."""
import dataclasses
import math

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import roofline as jax_roofline
from repro_torch.configs import ARCHS, cells_for_arch, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.roofline import (analytic_bytes, analytic_flops,
                                         roofline_terms)

REL = 1e-12
# (num_devices, tp, microbatches): one card, and the reference tests' mesh
LAYOUTS = [(1, 1, 1), (256, 16, 1), (512, 16, 4)]


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _cells(arch):
    return [s.name for s in cells_for_arch(get_config(arch))]


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert _cells(arch)
    for name in _cells(arch):
        shape, jshape = SHAPES[name], JAX_SHAPES[name]
        fl = dataclasses.asdict(analytic_flops(cfg, shape))
        jfl = dataclasses.asdict(jax_roofline.analytic_flops(jcfg, jshape))
        assert fl.keys() == jfl.keys()
        for k in fl:
            assert _close(fl[k], jfl[k]), (arch, name, k, fl[k], jfl[k])
        for nd, tp, mb in LAYOUTS:
            by = dataclasses.asdict(analytic_bytes(
                cfg, shape, num_devices=nd, tp=tp, microbatches=mb))
            jby = dataclasses.asdict(jax_roofline.analytic_bytes(
                jcfg, jshape, num_devices=nd, tp=tp, microbatches=mb))
            assert by.keys() == jby.keys()
            for k in by:
                assert _close(by[k], jby[k]), (arch, name, nd, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_terms_differ_only_by_the_peaks(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ratio = {"compute_s": jax_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "memory_s": jax_roofline.HBM_BW / roofline.HBM_BW,
             "collective_s": jax_roofline.LINK_BW / roofline.LINK_BW}
    for name in _cells(arch):
        for nd, tp, mb in LAYOUTS:
            kw = dict(num_devices=nd, tp=tp, collective_bytes_per_dev=1e9,
                      microbatches=mb)
            t = roofline_terms(cfg, SHAPES[name], **kw)
            j = jax_roofline.roofline_terms(jcfg, JAX_SHAPES[name], **kw)
            assert t.keys() == j.keys()
            for k, r in ratio.items():
                assert _close(t[k], j[k] * r), (arch, name, k)
            for k in ("hlo_flops_total", "model_flops", "useful_ratio",
                      "bytes_weights", "bytes_opt", "bytes_act",
                      "bytes_cache", "bytes_total"):
                assert _close(t[k], j[k]), (arch, name, k)
            step = max(t["compute_s"], t["memory_s"], t["collective_s"])
            assert t["dominant"] == max(
                ("compute", t["compute_s"]), ("memory", t["memory_s"]),
                ("collective", t["collective_s"]), key=lambda kv: kv[1])[0]
            assert _close(t["roofline_mfu"], t["model_flops"] / nd / step
                          / roofline.PEAK_FLOPS)


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_FP32, roofline.HBM_BW,
            roofline.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    doc = roofline.__doc__
    assert "H100 SXM" in doc and "NVLink" in doc
    for tpu in ("TPU", "v5e", "197", "819", "ICI"):
        assert tpu not in doc


def test_one_card_has_no_collective_term():
    t = roofline_terms(get_config("llama3_8b"), SHAPES["decode_32k"],
                       num_devices=1, tp=1, collective_bytes_per_dev=0.0)
    assert t["collective_s"] == 0.0 and t["dominant"] == "memory"


# ---------------------------------------------------------------------------
# tests/test_roofline.py's cases on the port
# ---------------------------------------------------------------------------
def test_dense_flops_close_to_6nd():
    cfg = get_config("llama3_8b")
    fl = analytic_flops(cfg, SHAPES["train_4k"])
    ratio = fl.hlo_equiv / fl.model_flops
    assert 1.0 < ratio < 2.2, ratio


def test_moe_active_params_flops():
    cfg = get_config("qwen3_moe_235b")
    shape = SHAPES["train_4k"]
    fl = analytic_flops(cfg, shape)
    assert fl.model_flops < 6 * cfg.param_count() * shape.seq_len \
        * shape.global_batch * 0.25


def test_decode_is_memory_bound():
    cfg = get_config("llama3_8b")
    t = roofline_terms(cfg, SHAPES["decode_32k"], num_devices=256, tp=16,
                       collective_bytes_per_dev=0.0)
    assert t["dominant"] == "memory"
    assert t["bytes_cache"] > t["bytes_weights"] * 0.5


def test_ssm_decode_state_not_quadratic():
    cfg = get_config("rwkv6_1b6")
    b32 = analytic_bytes(cfg, SHAPES["decode_32k"], num_devices=256, tp=16)
    long_shape = SHAPES["long_500k"]
    blong = analytic_bytes(cfg, long_shape, num_devices=256, tp=16)
    per_seq_32 = b32.cache / SHAPES["decode_32k"].global_batch * (256 / 16)
    per_seq_long = blong.cache / long_shape.global_batch * (256 / 16)
    assert abs(per_seq_32 - per_seq_long) / per_seq_long < 1e-6


def test_terms_scale_with_devices():
    cfg = get_config("llama3_8b")
    t256 = roofline_terms(cfg, SHAPES["train_4k"], num_devices=256, tp=16,
                          collective_bytes_per_dev=1e9)
    t512 = roofline_terms(cfg, SHAPES["train_4k"], num_devices=512, tp=16,
                          collective_bytes_per_dev=1e9)
    assert t512["compute_s"] < t256["compute_s"]
