"""First-person camera controller (counterpart of
``tpupt/interactive/camera_controller.py``).

The reference's interactive camera as a plain class: yaw/pitch mouse-look
with a ±pi/2 pitch clamp, WASD/RF translation in the camera frame,
log-scale speed.  ``viewer.InteractiveViewer`` drives it; it is as usable
headless, for scripted fly-throughs.
"""

from __future__ import annotations

import numpy as np

from tpupt_torch.core.camera import make_camera
from tpupt_torch.core.types import Camera


def _yaw_pitch_matrix(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return ry @ rx


class FirstPersonCameraController:
    def __init__(self, position=(0.0, 0.0, 0.0), yaw=0.0, pitch=0.0,
                 vfov=np.pi / 2, speed=1.0, mouse_sensitivity=0.003):
        self.position = np.asarray(position, np.float64).copy()
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.vfov = float(vfov)
        self.speed = float(speed)
        self.mouse_sensitivity = float(mouse_sensitivity)

    # --- input events ---------------------------------------------------
    def on_mouse_move(self, dx: float, dy: float) -> None:
        """Right-drag look (reference app.cpp:73-115)."""
        self.yaw -= dx * self.mouse_sensitivity
        self.pitch -= dy * self.mouse_sensitivity
        clamp = np.pi / 2 - 1e-3  # pitch clamp (controller.cpp:39-42)
        self.pitch = float(np.clip(self.pitch, -clamp, clamp))

    def move(self, key: str, dt: float = 1.0 / 60.0) -> None:
        """WASD forward/left/back/right, R/F up/down, in the camera frame
        (controller.cpp:53-95)."""
        local = {
            "w": (0, 0, -1), "s": (0, 0, 1),
            "a": (-1, 0, 0), "d": (1, 0, 0),
            "r": (0, 1, 0), "f": (0, -1, 0),
        }.get(key.lower())
        if local is None:
            return
        rot = _yaw_pitch_matrix(self.yaw, self.pitch)
        self.position += rot @ np.asarray(local, np.float64) * self.speed * dt

    def set_speed_log(self, log_speed: float) -> None:
        """Log-scale speed slider (controller.cpp:123-124)."""
        self.speed = float(np.exp(log_speed))

    # --- output ---------------------------------------------------------
    def camera(self) -> Camera:
        return make_camera(
            position=self.position,
            rotation=_yaw_pitch_matrix(self.yaw, self.pitch),
            vfov=self.vfov,
        )
