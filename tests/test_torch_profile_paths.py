"""The host-side helpers of ``polyphonicformer_torch/tools/profile_paths.py``."""
import pytest
import torch

from polyphonicformer_torch.tools import profile_paths


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 12), (20, 25)], 17.0),
    ([(3, 4), (0, 10), (2, 5)], 10.0),  # nested and unsorted
    ([(0, 1), (1, 2)], 2.0),  # touching
])
def test_busy_is_the_union_of_intervals(intervals, want):
    assert profile_paths.busy_us(intervals) == want


@pytest.mark.parametrize("name,cls", [
    ("(anonymous namespace)::mask_loss_bwd(float const*, ...)", "port"),
    ("void (anonymous namespace)::mask_loss_fwd<true>(float const*, ...)", "port"),
    ("void (anonymous namespace)::mask_loss_bwd<false>(float const*, ...)", "port"),
    ("upsample_int_fwd(float const*, float*, long long, int, int, int, int)", "port"),
    ("void (anonymous namespace)::mask_pool_mma<__nv_bfloat16, float>((anonymous namespace)::Params)",
     "port"),
    ("void (anonymous namespace)::upsample_int_fwd<2, 2>((anonymous namespace)::UpArgs)", "port"),
    ("void (anonymous namespace)::window_attn_kernel<__nv_bfloat16, true>(...)", "port"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "convolution"),
    ("cutlass_80_simt_sgemm_128x128_8x4_nn_align1", "matmul"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT", "matmul"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", "foreach"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("some_kernel", "other"),
])
def test_kernel_class(name, cls):
    assert profile_paths.kernel_class(name) == cls


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_main_refuses_without_a_card():
    assert profile_paths.main() == 1
