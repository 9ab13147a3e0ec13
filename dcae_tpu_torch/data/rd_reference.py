"""Golden rate-distortion numbers and the BD-rate.

The reference model's published RD points, 6 lambdas a dataset, are the
target a trained checkpoint is held to. The BD-rate (Bjontegaard delta
rate) is the average bitrate difference of two RD curves at equal quality,
the metric of the paper's headline (-17.0% against VVC on Kodak). The
numbers are a copy of the JAX package's table, so this package reads them
without it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# bpp / PSNR(dB) at the 6 MSE lambdas {0.05..0.0018}, high->low rate
REFERENCE_RD: Dict[str, Dict[str, list]] = {
    "Kodak": {
        "bpp": [0.8106, 0.5929, 0.4257, 0.2924, 0.1751, 0.1091],
        "psnr": [37.8716, 36.1096, 34.4087, 32.6784, 30.7364, 29.2415],
    },
    "CLIC": {
        "bpp": [0.5937, 0.4260, 0.3052, 0.2127, 0.1306, 0.0843],
        "psnr": [38.5750, 37.1192, 35.7093, 34.2402, 32.5757, 31.1935],
    },
    "Tecnick": {
        "bpp": [0.5510, 0.3982, 0.2917, 0.2086, 0.1361, 0.0928],
        "psnr": [38.6641, 37.2474, 35.8972, 34.4726, 32.8432, 31.4328],
    },
    # MS-SSIM-optimized models; quality = -10 log10(1 - msssim) dB
    "Kodak-msssim": {
        "bpp": [0.6072, 0.4496, 0.3325, 0.2288, 0.1518, 0.1037],
        "msssim_db": [21.6959, 20.1282, 18.6204, 16.9128, 15.0622, 13.5878],
    },
}

MSE_LAMBDAS = (0.05, 0.025, 0.013, 0.0067, 0.0035, 0.0018)
MSSSIM_LAMBDAS = (60.5, 31.73, 16.64, 8.73, 4.58, 2.40)


def bd_rate(ref_bpp: Sequence[float], ref_q: Sequence[float],
            test_bpp: Sequence[float], test_q: Sequence[float]) -> float:
    """Bjontegaard delta-rate (%) of test vs reference curves.

    Cubic polynomial fit of log-rate as a function of quality, integrated
    over the overlapping quality range; negative = test needs fewer bits.
    """
    ref_bpp = np.asarray(ref_bpp, np.float64)
    ref_q = np.asarray(ref_q, np.float64)
    test_bpp = np.asarray(test_bpp, np.float64)
    test_q = np.asarray(test_q, np.float64)

    lr_ref = np.log(ref_bpp)
    lr_test = np.log(test_bpp)

    # cubic when the curve has >=4 points (the standard Bjontegaard fit);
    # degrade gracefully for short curves instead of a rank-deficient fit
    p_ref = np.polyfit(ref_q, lr_ref, min(3, len(ref_q) - 1))
    p_test = np.polyfit(test_q, lr_test, min(3, len(test_q) - 1))

    lo = max(ref_q.min(), test_q.min())
    hi = min(ref_q.max(), test_q.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in quality")

    pi_ref = np.polyint(p_ref)
    pi_test = np.polyint(p_test)
    int_ref = np.polyval(pi_ref, hi) - np.polyval(pi_ref, lo)
    int_test = np.polyval(pi_test, hi) - np.polyval(pi_test, lo)

    avg_diff = (int_test - int_ref) / (hi - lo)
    return float((np.exp(avg_diff) - 1.0) * 100.0)


def compare_to_reference(dataset: str, bpp: Sequence[float],
                         psnr: Sequence[float]) -> float:
    """BD-rate (%) of measured points vs the golden curve; negative beats
    the reference."""
    golden = REFERENCE_RD[dataset]
    q_key = "psnr" if "psnr" in golden else "msssim_db"
    return bd_rate(golden["bpp"], golden[q_key], bpp, psnr)
