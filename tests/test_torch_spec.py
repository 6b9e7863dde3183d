"""The PyTorch package's copy of the spec layer against the JAX package's:
plans, layouts and cache names over a sweep of option strings from
docs/url-options.md, garbage values included."""

import dataclasses

import pytest
import torch

from flyimg_tpu.ops import compose as jcompose
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec import plan as jplan_mod
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.exceptions import InvalidArgumentException
from flyimg_tpu_torch.ops import compose as tcompose
from flyimg_tpu_torch.spec.options import OptionsBag as TOptionsBag
from flyimg_tpu_torch.spec import plan as tplan_mod
from flyimg_tpu_torch.spec.plan import build_plan as tbuild_plan

torch.set_num_threads(1)

OPTION_STRINGS = [
    "w_300,h_250,c_1",
    "w_300,h_250,c_1,smc_1",
    "w_300",
    "h_250",
    "w_200,h_100",
    "w_200,h_100,c_1,g_NorthWest",
    "w_200,h_100,c_1,g_South",
    "w_200,h_100,c_1,g_East",
    "w_2000,h_2000,pns_1",
    "w_2000,pns_0",
    "w_300,par_0,h_100",
    "sc_50",
    "w_100,sc_150",
    "e_1,p1x_10,p1y_20,p2x_200,p2y_150",
    "e_1,p1x_10,p1y_20,p2x_200,p2y_150,w_100",
    "w_300,h_250,ett_400x320,g_SouthEast,bg_red",
    "w_300,ett_300x300",
    "w_200,r_90",
    "w_200,r_-45,bg_blue",
    "w_200,clsp_Gray",
    "w_200,mnchr_1",
    "w_200,unsh_0.25x0.25+8+0.065",
    "w_200,sh_2x1",
    "w_200,blr_1x0.5",
    "w_200,f_triangle",
    "w_200,f_point",
    "w_200,f_NotAFilter",
    "w_200,o_png,q_80",
    "w_200,rf_1",
    "w_abc",
    "w_-5,h_0",
    "r_NaN",
    "r_abc",
    "g_North_West,w_100,h_100,c_1",
    "bg_%23999999,w_100",
    "tm_00:00:10",
    "",
]
SOURCES = [(1920, 1080), (512, 512), (640, 480), (97, 301)]


def _plan_dict(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("opts", OPTION_STRINGS)
def test_plans_layouts_and_names_match(opts):
    url = "https://example.com/images/a.png?x=1"
    jopts, topts = JOptionsBag(opts), TOptionsBag(opts)
    assert topts.hashed_options_as_string(url) == jopts.hashed_options_as_string(url)
    assert TOptionsBag.hash_original_image_url(url) == JOptionsBag.hash_original_image_url(url)
    assert tplan_mod.decode_target_hint(topts) == jplan_mod.decode_target_hint(jopts)
    for w, h in SOURCES:
        try:
            jplan = jbuild_plan(jopts, w, h)
        except Exception as exc:  # the port must refuse the same way
            with pytest.raises(InvalidArgumentException) as info:
                tbuild_plan(topts, w, h)
            assert str(info.value) == str(exc)
            continue
        tplan = tbuild_plan(topts, w, h)
        assert _plan_dict(tplan) == _plan_dict(jplan)
        assert tplan.signature() == jplan.signature()
        assert _plan_dict(tplan.device_plan()) == _plan_dict(jplan.device_plan())
        assert dataclasses.astuple(tcompose.plan_layout(tplan)) == \
            dataclasses.astuple(jcompose.plan_layout(jplan))
        assert tcompose.final_extent(tplan, tcompose.plan_layout(tplan)) == \
            jcompose.final_extent(jplan, jcompose.plan_layout(jplan))
        assert tplan_mod.decode_roi_window(tplan) == jplan_mod.decode_roi_window(jplan)
        assert tplan.final_size == jplan.final_size


@pytest.mark.parametrize("n", [1, 2, 3, 5, 64, 65])
def test_bucket_helpers_match(n):
    assert tcompose.bucket_batch(n) == jcompose.bucket_batch(n)
    assert tcompose._bucket_dim(n * 37) == jcompose._bucket_dim(n * 37)
    assert tcompose._bucket_dim(n * 7, 32) == jcompose._bucket_dim(n * 7, 32)
