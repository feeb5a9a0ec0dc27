"""Color utilities, copied from gdpt_tpu/core/spectrum.py.

luminance and avg take numpy arrays or tensors of (..., 3) linear RGB
(reference: src/spectrum.h:8-32). Host side (numpy): sRGB decoding and
CIE-1931 integration of tabulated spectra to linear RGB using Wyman et
al.'s analytic response fits (reference: src/spectrum.h:48-118).
"""

import numpy as np

LUMA = (0.212671, 0.715160, 0.072169)


def luminance(s):
    """Rec.709 luminance (reference: src/spectrum.h:32)."""
    return s[..., 0] * LUMA[0] + s[..., 1] * LUMA[1] + s[..., 2] * LUMA[2]


def avg(s):
    return s.mean(-1)


def _x_fit_1931(w):
    t1 = (w - 442.0) * np.where(w < 442.0, 0.0624, 0.0374)
    t2 = (w - 599.8) * np.where(w < 599.8, 0.0264, 0.0323)
    t3 = (w - 501.1) * np.where(w < 501.1, 0.0490, 0.0382)
    return (
        0.362 * np.exp(-0.5 * t1 * t1)
        + 1.056 * np.exp(-0.5 * t2 * t2)
        - 0.065 * np.exp(-0.5 * t3 * t3)
    )


def _y_fit_1931(w):
    t1 = (w - 568.8) * np.where(w < 568.8, 0.0213, 0.0247)
    t2 = (w - 530.9) * np.where(w < 530.9, 0.0613, 0.0322)
    return 0.821 * np.exp(-0.5 * t1 * t1) + 0.286 * np.exp(-0.5 * t2 * t2)


def _z_fit_1931(w):
    t1 = (w - 437.0) * np.where(w < 437.0, 0.0845, 0.0278)
    t2 = (w - 459.0) * np.where(w < 459.0, 0.0385, 0.0725)
    return 1.217 * np.exp(-0.5 * t1 * t1) + 0.681 * np.exp(-0.5 * t2 * t2)


_CIE_Y_INTEGRAL = 106.856895


def integrate_xyz(wavelengths, values):
    """Integrate a piecewise-linear tabulated spectrum against the CIE
    response fits over [400, 700] nm at 1 nm steps (reference:
    src/spectrum.h:72-111, including clamping to the last table entry
    past the table's end)."""
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    if wavelengths.size == 0:
        return np.zeros(3)
    grid = np.arange(400.0, 701.0, 1.0)
    meas = np.interp(grid, wavelengths, values, left=0.0, right=values[-1])
    meas = np.where(grid < wavelengths[0], 0.0, meas)
    x = np.sum(_x_fit_1931(grid) * meas)
    y = np.sum(_y_fit_1931(grid) * meas)
    z = np.sum(_z_fit_1931(grid) * meas)
    return np.array([x, y, z]) / _CIE_Y_INTEGRAL


def xyz_to_rgb(xyz):
    m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875991, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ]
    )
    return m @ np.asarray(xyz)


def spectrum_to_rgb(wavelengths, values):
    return xyz_to_rgb(integrate_xyz(wavelengths, values))


def srgb_to_linear(srgb):
    srgb = np.asarray(srgb, dtype=np.float64)
    return np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    )
