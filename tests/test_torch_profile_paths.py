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


class _Event:
    def __init__(self, start, end):
        from torch.autograd import DeviceType

        self.device_type, self.is_user_annotation = DeviceType.CUDA, False
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.name = "k"


def test_idle_share_is_of_the_profiled_wall(monkeypatch):
    """Unprofiled runs take 10 ms, the profiled one 40 ms; its kernels are
    busy 30 ms (two overlapping and one apart): idle 1 - 30 / 40."""
    clock = [0.0]
    profiling = [False]

    class _Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            profiling[0] = True
            return self

        def __exit__(self, *exc):
            profiling[0] = False

        def events(self):
            return [_Event(0, 15_000), _Event(5_000, 20_000), _Event(25_000, 35_000)]

    def run():
        clock[0] += 0.040 if profiling[0] else 0.010

    monkeypatch.setattr(profile_paths.time, "perf_counter", lambda: clock[0])
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 2 ** 30)
    info = profile_paths.measure("unit", run, warm=3)
    assert info["median_wall_ms"] == pytest.approx(10.0)
    assert info["profiled_wall_ms"] == pytest.approx(40.0)
    assert info["device_busy_ms"] == pytest.approx(30.0)
    assert info["idle_share"] == pytest.approx(0.25)
    assert info["kernels"] == 3 and info["peak_mem_gib"] == 1.0
