"""Canvas and P3 PPM writer (counterpart of rtc_tpu/io/canvas.py;
reference: src/canvas.rs).

The canvas is a float64 (H, W, 3) numpy image on the host; colours stay
unclamped until serialization, as in the reference. The PPM text matches
rtc_tpu's byte for byte: "P3" header, max value 255, each channel clamped
to [0, 1] and rounded half away from zero to 0..255 in float64, rows
wrapped at 70 characters, and a trailing newline (reference:
src/canvas.rs:28-63). A rendered tensor is copied to the host once and
widened there, so the port and rtc_tpu quantize the same float64 values.
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch

from .. import native


class Canvas:
    """Row-major framebuffer (reference: src/canvas.rs:5-26)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.pixels = np.zeros((height, width, 3), dtype=np.float64)

    @classmethod
    def from_image(cls, image) -> "Canvas":
        """A canvas holding an (H, W, 3) image: a numpy array, or a tensor
        on any device, copied to the host once."""
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        image = np.asarray(image)
        c = cls(image.shape[1], image.shape[0])
        c.pixels = image.astype(np.float64)
        return c

    def get_pixel(self, x: int, y: int):
        return self.pixels[y, x]

    def set_pixel(self, x: int, y: int, color) -> None:
        self.pixels[y, x] = np.asarray(color, dtype=np.float64)

    def to_ppm_string(self) -> str:
        buf = _io.StringIO()
        self.write_ppm(buf)
        return buf.getvalue()

    def write_ppm(self, out) -> None:
        """The PPM text into the text stream `out`, in Python
        (reference: src/canvas.rs:28-58)."""
        out.write("P3\n")
        out.write(f"{self.width} {self.height}\n")
        out.write("255\n")
        # clamp [0,1] -> round-half-away-from-zero to 0..255
        # (Rust's f64::round — reference: src/canvas.rs:61-63)
        vals = np.floor(np.clip(self.pixels, 0.0, 1.0) * 255.0 + 0.5).astype(np.int64)
        for y in range(self.height):
            line_len = 0
            for v in vals[y].reshape(-1).tolist():
                s = str(v)
                if line_len + len(s) + 1 > 70:
                    out.write("\n")
                    line_len = 0
                if line_len > 0:
                    out.write(" ")
                    line_len += 1
                out.write(s)
                line_len += len(s)
            out.write("\n")

    def save(self, path: str) -> None:
        """Write the PPM file: through the C++ encoder when
        native/librtc_native.so is present, else in Python (same bytes)."""
        data = native.encode_ppm(self.pixels)
        if data is not None:
            with open(path, "wb") as f:
                f.write(data)
        else:
            with open(path, "w", newline="\n") as f:
                self.write_ppm(f)


def write_ppm(image, path: str) -> None:
    """Write an (H, W, 3) float image (numpy, or a tensor on any device)
    to a PPM file."""
    Canvas.from_image(image).save(path)
