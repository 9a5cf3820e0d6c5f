"""Progressive viewer (counterpart of ``tpupt/interactive/viewer.py``).

The reference's GLFW/ImGui app offers progressive refinement within a
frame budget, restart on a camera move, right-drag mouse look, a live
panel (denoiser sliders and the render-method combo), display-buffer
switching and a first-person camera.  Here they are methods of
``InteractiveViewer`` that run headless (``step_frame``, ``on_key``, the
mouse handlers, ``set_option``), and ``run()`` wires them to a matplotlib
window; matplotlib is imported only there.  The render runs on the
tracer's device.

Keys:  wasd/rf move · arrows look · right-drag look · space restart ·
       n/c/z/x buffer select (final/color/normal/depth) · e toggle
       denoiser · q quit
Panel: denoiser on/off, filter size, color/normal/position weights and
       the megakernel/streaming combo; the same knobs are scriptable
       through ``set_option``.
"""

from __future__ import annotations

import time

import numpy as np

from tpupt_torch.interactive.camera_controller import FirstPersonCameraController
from tpupt_torch.render.progressive import METHODS, PathTracer


class InteractiveViewer:
    FRAME_BUDGET_S = 0.016  # the reference renders as many iterations as
    # fit in 16 ms per frame

    #: live panel knobs -> PathTracer fields
    PANEL_OPTIONS = (
        "denoiser_enabled", "filter_size",
        "color_weight", "normal_weight", "position_weight",
        "method",
    )

    #: while the camera moves, render one sample at 1/PREVIEW_SCALE
    #: resolution per frame (upscaled for display), and go back to
    #: full-resolution progressive accumulation when idle
    PREVIEW_SCALE = 4
    MOVE_IDLE_S = 0.25  # the camera counts as moving this long after input
    #: bounce cap of the motion preview, which is an approximation by design
    PREVIEW_MAX_BOUNCES = 8

    def __init__(self, tracer: PathTracer, controller: FirstPersonCameraController):
        self.tracer = tracer
        self.controller = controller
        self.display_type = "final"
        self.denoise = False
        self._drag: tuple[float, float] | None = None
        self._last_motion = -1e9
        self._preview: PathTracer | None = None

    def _note_motion(self) -> None:
        self._last_motion = time.perf_counter()

    @property
    def moving(self) -> bool:
        return (time.perf_counter() - self._last_motion) < self.MOVE_IDLE_S

    def _preview_tracer(self) -> PathTracer:
        """The 1/PREVIEW_SCALE-resolution tracer on the same scene, made
        when first needed."""
        s = self.PREVIEW_SCALE
        w = max(self.tracer.width // s, 8)
        h = max(self.tracer.height // s, 8)
        if self._preview is None or (self._preview.width, self._preview.height) != (w, h):
            rr = self.tracer.rr_start
            self._preview = PathTracer(
                self.tracer.scene, (w, h),
                max_bounces=min(self.PREVIEW_MAX_BOUNCES, self.tracer.max_bounces),
                rr_start=min(rr, 2) if rr is not None else 2,
            )
        return self._preview

    def step_frame(self) -> np.ndarray:
        """Refine within the frame budget and return the display image.

        While the camera moves: one sample at 1/PREVIEW_SCALE resolution
        (``PathTracer.preview_frame``, for every display type), upscaled by
        repetition.  Idle: full-resolution progressive samples until the
        frame budget is spent."""
        camera = self.controller.camera()
        if self.moving and self.PREVIEW_SCALE > 1:
            pv = self._preview_tracer()
            img = pv.preview_frame(camera, self.PREVIEW_MAX_BOUNCES, self.display_type)
            sy = -(-self.tracer.height // pv.height)  # per-axis factors:
            sx = -(-self.tracer.width // pv.width)  # the min-8 clamp can
            return np.repeat(np.repeat(img, sy, axis=0), sx, axis=1)[
                : self.tracer.height, : self.tracer.width
            ]
        start = time.perf_counter()
        while True:
            self.tracer.path_trace(camera)
            if time.perf_counter() - start > self.FRAME_BUDGET_S:
                break
        if self.denoise or self.tracer.denoiser_enabled:
            self.tracer.denoise(camera)
        return self.tracer.display(self.display_type)

    # --- input events (headless; run() wires them to matplotlib) ----------
    def on_key(self, key: str) -> bool:
        """Handle one key; returns False to quit."""
        if key == "q":
            return False
        if key == " ":
            self.tracer.restart()
        elif key in "wasdrf":
            self.controller.move(key, dt=0.1)
            self.tracer.restart()
            self._note_motion()
        elif key in ("left", "right", "up", "down"):
            dx = {"left": -40, "right": 40}.get(key, 0)
            dy = {"up": -40, "down": 40}.get(key, 0)
            self.controller.on_mouse_move(dx, dy)
            self.tracer.restart()
            self._note_motion()
        elif key == "e":
            self.denoise = not self.denoise
        elif key in "nczx":
            self.display_type = {
                "n": "normal", "c": "color", "z": "depth", "x": "final"
            }[key]
        return True

    def on_mouse_press(self, x: float, y: float, button: int = 3) -> None:
        """A right-button press starts a look-drag (matplotlib's right
        button is 3)."""
        if button == 3:
            self._drag = (float(x), float(y))

    def on_mouse_motion(self, x: float, y: float) -> bool:
        """Drag-look: the pixel delta since the last event turns the camera
        and restarts accumulation.  ``y`` is in matplotlib's canvas
        coordinates (origin bottom-left), so the vertical delta is negated
        to the screen-down convention the controller expects.  Returns True
        while a drag is active."""
        if self._drag is None:
            return False
        dx = float(x) - self._drag[0]
        dy = -(float(y) - self._drag[1])
        self._drag = (float(x), float(y))
        if dx or dy:
            self.controller.on_mouse_move(dx, dy)
            self.tracer.restart()
            self._note_motion()
        return True

    def on_mouse_release(self, button: int = 3) -> None:
        if button == 3:
            self._drag = None

    def set_option(self, name: str, value) -> None:
        """The live panel's setter.  A denoiser knob only drops the
        denoised image; a new render method restarts accumulation (the
        reference restarts on path-tracing option edits), and the next
        sample runs the other integrator."""
        if name not in self.PANEL_OPTIONS:
            raise ValueError(f"unknown panel option {name!r}")
        if name == "method":
            if value not in METHODS:
                raise ValueError(f"unknown method {value!r}")
            if value != self.tracer.method:
                self.tracer.method = value
                self.tracer.restart()
            return
        setattr(
            self.tracer,
            name,
            bool(value) if name == "denoiser_enabled"
            else int(value) if name == "filter_size"
            else float(value),
        )
        # the next frame denoises again with the new weights
        self.tracer._denoised = None

    # --- event loop -------------------------------------------------------
    def run(self, max_frames: int | None = None, panel: bool = True) -> None:
        """The matplotlib event loop (needs a GUI backend)."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(9, 6))
        ax = fig.add_axes([0.02, 0.05, 0.64, 0.9])
        im = ax.imshow(self.step_frame())
        ax.set_axis_off()
        state = {"running": True}

        def key_press(event):
            if not self.on_key(event.key or ""):
                state["running"] = False

        def mouse_press(event):
            if event.inaxes is ax and event.button is not None:
                self.on_mouse_press(event.x, event.y, int(event.button))

        def mouse_motion(event):
            self.on_mouse_motion(event.x, event.y)

        def mouse_release(event):
            if event.button is not None:
                self.on_mouse_release(int(event.button))

        fig.canvas.mpl_connect("key_press_event", key_press)
        fig.canvas.mpl_connect("button_press_event", mouse_press)
        fig.canvas.mpl_connect("motion_notify_event", mouse_motion)
        fig.canvas.mpl_connect("button_release_event", mouse_release)

        widgets = self._build_panel(fig) if panel else None  # noqa: F841

        frames = 0
        while state["running"] and plt.fignum_exists(fig.number):
            im.set_data(self.step_frame())
            ax.set_title(f"iteration {self.tracer.iteration}")
            fig.canvas.draw_idle()
            plt.pause(0.001)
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break

    def _build_panel(self, fig):
        """The denoiser and method widgets (the caller keeps them alive:
        matplotlib widgets are garbage-collected otherwise)."""
        from matplotlib.widgets import CheckButtons, RadioButtons, Slider

        t = self.tracer
        cax = fig.add_axes([0.72, 0.80, 0.24, 0.10])
        check = CheckButtons(cax, ["denoise"], [t.denoiser_enabled])
        check.on_clicked(
            lambda _l: self.set_option("denoiser_enabled", not t.denoiser_enabled)
        )

        sliders = []
        for i, (name, lo, hi, val) in enumerate([
            ("filter_size", 1, 40, t.filter_size),
            ("color_weight", 0.0, 1.0, t.color_weight),
            ("normal_weight", 0.0, 1.0, t.normal_weight),
            ("position_weight", 0.0, 1.0, t.position_weight),
        ]):
            sax = fig.add_axes([0.78, 0.70 - 0.07 * i, 0.18, 0.03])
            s = Slider(sax, name, lo, hi, valinit=val)
            s.on_changed(lambda v, n=name: self.set_option(n, v))
            sliders.append(s)

        rax = fig.add_axes([0.72, 0.25, 0.24, 0.12])
        radio = RadioButtons(
            rax, list(METHODS),
            active=METHODS.index(t.method),
        )
        radio.on_clicked(lambda label: self.set_option("method", label))
        return check, sliders, radio
