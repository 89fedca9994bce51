"""Live visualization windows, the reference's ``cv::imshow`` channel.

The port's counterpart of ``srmeetsps_cuda_tpu/io/liveview.py``. The
reference opens three OpenCV windows every outer iteration (SRPS.cu:319-327):
"Normals-Initial" (the normals at initialisation, SRPS.cu:270),
"Normals-Current-Iteration" and "Albedo", left to right at ``scale =
0.425`` with ``cv::moveWindow`` offsets from the image height, then
``cv::waitKey(5)``; after the solve it waits on ``cv::waitKey(0)``
(SRPS.cu:338).

The images are the PNG encoders of :mod:`.writers` (``normals_image`` /
``albedo_image``, Utilities.cpp:242-298). cv2 is optional: without it, or
without a display, the viewer disables itself with a warning, and ``--viz``
writes the same images as PNG files.
"""

from __future__ import annotations

import os
import sys
import warnings

from . import writers

# SRPS.cu:320: the reference's preview scale.
REFERENCE_SCALE = 0.425


class LiveView:
    """The reference's three preview windows, titles and layout.

    ``scale`` is the preview's downscale factor (the reference's 0.425);
    ``cv2_module`` replaces ``import cv2`` (tests pass a fake)."""

    @staticmethod
    def _default_cv2():
        try:
            import cv2

            return cv2
        except ImportError:
            return None

    def __init__(self, scale: float = REFERENCE_SCALE, cv2_module=None):
        self.scale = float(scale)
        self.enabled = True
        self._shown = False
        self._init_img = None
        self._cv2 = (cv2_module if cv2_module is not None
                     else self._default_cv2())
        if self._cv2 is None:
            warnings.warn("cv2 not available; --show disabled "
                          "(use --viz for PNG output)")
            self.enabled = False
        elif (cv2_module is None and sys.platform.startswith("linux")
              and not (os.environ.get("DISPLAY")
                       or os.environ.get("WAYLAND_DISPLAY"))):
            # Checked before the first imshow: cv2's Qt backend aborts the
            # process on a missing display instead of raising.
            warnings.warn("no display (DISPLAY/WAYLAND_DISPLAY unset); "
                          "--show disabled (use --viz for PNG output)")
            self.enabled = False

    def _imshow(self, title: str, img_u8, x: int, y: int):
        cv2 = self._cv2
        img = img_u8[..., ::-1]  # the encoders give RGB, cv2 shows BGR
        if self.scale != 1.0:
            img = cv2.resize(img, (0, 0), fx=self.scale, fy=self.scale)
        cv2.imshow(title, img)
        cv2.moveWindow(title, x, y)

    def set_initial(self, state, mask):
        """Keep the normals at initialisation (SRPS.cu:270) for the first
        window of every later :meth:`show`."""
        if self.enabled:
            self._init_img = writers.normals_image(state.N, mask)

    def show(self, state, mask):
        """The three windows of one outer iteration (SRPS.cu:319-327:
        imshow and moveWindow three times, then waitKey(5))."""
        if not self.enabled:
            return
        h = writers.to_host(mask).shape[0]
        # The reference steps the windows by the image height
        # (SRPS.cu:322-326).
        step = int(30 + h * self.scale)
        try:
            if self._init_img is not None:
                self._imshow("Normals-Initial", self._init_img, 10, 10)
            self._imshow("Normals-Current-Iteration",
                         writers.normals_image(state.N, mask), step, 10)
            self._imshow("Albedo", writers.albedo_image(state.rho, mask),
                         int(30 + 2 * h * self.scale), 10)
            self._cv2.waitKey(5)
            self._shown = True
        except Exception as e:  # a headless cv2 raises cv2.error
            warnings.warn(f"live view disabled ({e}); "
                          "use --viz for PNG output")
            self.enabled = False

    def finish(self):
        """Wait for a key, as the reference does after the solve
        (SRPS.cu:338 ``cv::waitKey(0)``); nothing if nothing was shown."""
        if self.enabled and self._shown:
            self._cv2.waitKey(0)
