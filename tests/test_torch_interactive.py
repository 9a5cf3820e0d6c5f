"""The port's interactive layer (``tpupt_torch.interactive``) headless, as
``test_interactive.py`` checks the JAX package's: the first-person camera
controller's math (held against the JAX package's controller: camera
matrices at rtol 1e-6, float32 of the same float64 host math) and the
viewer's frame loop, keys, drag, panel and motion preview (CPU: the
port's tracer runs its torch twins).
"""

import numpy as np
import pytest
import torch

from tpupt.interactive.camera_controller import FirstPersonCameraController as JaxController

from test_torch_scene import port_scene
from tpupt_torch import PathTracer
from tpupt_torch.interactive.camera_controller import FirstPersonCameraController
from tpupt_torch.interactive.viewer import InteractiveViewer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(sphere_scene):
    return port_scene(sphere_scene)


def _viewer(scene, size=16):
    tracer = PathTracer(scene, (size, size), max_bounces=2)
    viewer = InteractiveViewer(tracer, FirstPersonCameraController(vfov=np.pi / 2))
    viewer.FRAME_BUDGET_S = 0.0  # one iteration per frame in tests
    return tracer, viewer.controller, viewer


def test_controller_look_and_pitch_clamp():
    c = FirstPersonCameraController()
    c.on_mouse_move(100.0, 0.0)
    assert c.yaw < 0  # dragging right turns right (yaw decreases)
    for _ in range(100):
        c.on_mouse_move(0.0, -10000.0)
    assert c.pitch <= np.pi / 2
    m = c.camera().camera_matrix.numpy()
    np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-5)


def test_controller_moves_in_camera_frame():
    c = FirstPersonCameraController(speed=1.0)
    c.move("w", dt=1.0)
    np.testing.assert_allclose(c.position, [0, 0, -1], atol=1e-6)  # forward = -z
    c2 = FirstPersonCameraController(yaw=np.pi / 2, speed=1.0)
    c2.move("w", dt=1.0)
    np.testing.assert_allclose(c2.position, [-1, 0, 0], atol=1e-6)
    c3 = FirstPersonCameraController(speed=1.0)
    c3.move("r", dt=0.5)
    np.testing.assert_allclose(c3.position, [0, 0.5, 0], atol=1e-6)


def test_speed_log_scale():
    c = FirstPersonCameraController()
    c.set_speed_log(0.0)
    assert abs(c.speed - 1.0) < 1e-6
    c.set_speed_log(1.0)
    assert abs(c.speed - np.e) < 1e-6


def test_controller_matches_jax():
    """The same input events give the same pose and camera."""
    ours, theirs = FirstPersonCameraController(speed=2.0), JaxController(speed=2.0)
    for c in (ours, theirs):
        c.on_mouse_move(37.0, -12.0)
        for key in "wdrx":
            c.move(key, dt=0.3)
        c.set_speed_log(0.5)
        c.move("a", dt=0.2)
    np.testing.assert_array_equal(ours.position, theirs.position)
    assert (ours.yaw, ours.pitch, ours.speed) == (theirs.yaw, theirs.pitch, theirs.speed)
    a, b = ours.camera(), theirs.camera()
    np.testing.assert_allclose(a.camera_matrix.numpy(), np.asarray(b.camera_matrix), rtol=1e-6)
    assert a.vfov == pytest.approx(float(b.vfov))


def test_viewer_progressive_and_keys(scene):
    tracer, _, viewer = _viewer(scene)
    img = viewer.step_frame()
    assert img.shape == (16, 16, 3)
    it0 = tracer.iteration
    viewer.step_frame()
    assert tracer.iteration > it0

    # a camera move restarts accumulation
    assert viewer.on_key("w")
    assert tracer.iteration == 0
    viewer.step_frame()

    # display buffer cycling, the denoise toggle, quit
    assert viewer.on_key("n") and viewer.display_type == "normal"
    assert viewer.on_key("z") and viewer.display_type == "depth"
    assert viewer.on_key("x") and viewer.display_type == "final"
    assert viewer.on_key("e") and viewer.denoise
    img = viewer.step_frame()  # the denoised path
    assert img.shape == (16, 16, 3)
    assert viewer.on_key(" ") and tracer.iteration == 0
    assert not viewer.on_key("q")


def test_viewer_drag_look(scene):
    """A right-button drag turns the camera and restarts accumulation;
    motion without the button held does nothing."""
    tracer, ctl, viewer = _viewer(scene)
    ctl.yaw = ctl.pitch = 0.0
    viewer.step_frame()
    assert tracer.iteration > 0

    assert not viewer.on_mouse_motion(10.0, 10.0)  # no drag active
    viewer.on_mouse_press(100.0, 100.0, button=1)  # left button: ignored
    assert not viewer.on_mouse_motion(110.0, 100.0)

    viewer.on_mouse_press(100.0, 100.0, button=3)
    assert viewer.on_mouse_motion(150.0, 100.0)
    assert ctl.yaw < 0
    assert tracer.iteration == 0

    # canvas y grows up in matplotlib: dragging the cursor up pitches up
    viewer.step_frame()
    assert viewer.on_mouse_motion(150.0, 140.0)
    assert ctl.pitch > 0
    viewer.on_mouse_release(button=3)
    assert not viewer.on_mouse_motion(0.0, 0.0)


def test_viewer_panel_options(scene):
    """Denoiser knobs apply without a restart; the method combo restarts
    and the next frame runs the other integrator."""
    tracer, _, viewer = _viewer(scene)
    viewer.step_frame()

    viewer.set_option("denoiser_enabled", True)
    viewer.set_option("filter_size", 4)
    viewer.set_option("color_weight", 0.9)
    assert tracer.denoiser_enabled and tracer.filter_size == 4
    assert abs(tracer.color_weight - 0.9) < 1e-9
    assert viewer.step_frame().shape == (16, 16, 3)  # the panel's denoise path

    assert tracer.iteration > 0
    viewer.set_option("method", "streaming")
    assert tracer.method == "streaming" and tracer.iteration == 0
    viewer.set_option("denoiser_enabled", False)
    img_stream = viewer.step_frame()
    # the wavefront sample equals the megakernel's
    mega = PathTracer(scene, (16, 16), max_bounces=2)
    mega.path_trace(viewer.controller.camera())
    np.testing.assert_array_equal(img_stream, mega.display("final"))
    assert set(InteractiveViewer.PANEL_OPTIONS) == {
        "denoiser_enabled", "filter_size", "color_weight", "normal_weight", "position_weight",
        "method"}

    with pytest.raises(ValueError, match="method"):
        viewer.set_option("method", "warp")
    with pytest.raises(ValueError, match="option"):
        viewer.set_option("no_such_knob", 1)


def test_viewer_preview_resolution_while_moving(scene):
    """While the camera moves, step_frame renders one sample at
    1/PREVIEW_SCALE resolution and upscales it; the full-resolution
    accumulator does not advance.  Idle again, refinement resumes."""
    tracer, _, viewer = _viewer(scene, size=32)
    viewer.step_frame()
    assert tracer.iteration > 0

    assert viewer.on_key("w")
    assert viewer.moving
    img = viewer.step_frame()
    assert img.shape == (32, 32, 3)
    assert tracer.iteration == 0
    assert viewer._preview is not None
    assert viewer._preview.width == 32 // viewer.PREVIEW_SCALE

    viewer._last_motion = -1e9  # idle again
    assert not viewer.moving
    viewer.step_frame()
    assert tracer.iteration > 0


def test_motion_preview_for_all_display_types(scene):
    """Every display type's motion preview is the one-sample
    ``preview_frame`` (the preview tracer's accumulator never advances)."""
    tracer, ctl, viewer = _viewer(scene, size=32)
    assert viewer.on_key("w")
    for key, dtype in (("x", "final"), ("c", "color"), ("n", "normal"), ("z", "depth")):
        assert viewer.on_key(key) and viewer.display_type == dtype
        viewer._note_motion()
        img = viewer.step_frame()
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
        assert viewer._preview.iteration == 0, dtype
        direct = viewer._preview.preview_frame(ctl.camera(), viewer.PREVIEW_MAX_BOUNCES, dtype)
        s = viewer.PREVIEW_SCALE
        np.testing.assert_array_equal(img[::s, ::s], direct)

