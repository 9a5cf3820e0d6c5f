"""The trace reduction on a synthetic trace."""

from h100bench.trace import Interval, reduce


def test_busy_idle_and_gap_names():
    dev = [Interval("trip_head_kernel", 0, 10), Interval("treelet_closest_hit_kernel", 5, 15),
           Interval("Memcpy DtoH", 20, 22), Interval("trip_tail_kernel", 30, 40)]
    host = [Interval("h100bench.render_image", -5, 50), Interval("aten::item", 14, 21),
            Interval("cudaLaunchKernel", 23, 29)]
    r = reduce(dev, host)
    assert abs(r.busy_s - 27e-6) < 1e-12  # [0, 15] + [20, 22] + [30, 40]
    window = 50e-6
    assert abs(100 * (1 - r.busy_s / window) - 46.0) < 1e-9
    assert r.kernels == 3 and r.count("trip_") == 2
    assert abs(r.seconds("trip_head", "trip_tail") - 20e-6) < 1e-12
    assert r.idle_gaps[0][0] == "h100bench.render_image > cudaLaunchKernel"
    assert abs(r.idle_gaps[0][1] - 8e-6) < 1e-12
    assert r.idle_gaps[1][0] == "h100bench.render_image > aten::item"
    assert [n for n, _ in r.top_ops][:2] == ["trip_head_kernel", "treelet_closest_hit_kernel"]
