"""LiDAR-Iris place-recognition descriptor, batched in jnp (array-program
re-design of the vendored reference implementation,
reference thirdparty/LidarIris/LidarIris.cpp).

  * GetIris: bin points into an 80(range-rings) x 360(yaw) image whose
    pixels are 8-bit occupancy masks over z in [-5, 3)
    (LidarIris.cpp:4-19) — here a scatter-add onto (80, 360, 8) + bit
    packing;
  * GetFeature: 1-D log-Gabor filter bank (4 scales) along rows via FFT
    (LogGaborFilter, :84-133), binarized by re/im sign into T and a
    low-magnitude mask M (LoGFeatureEncode, :135-154) — binary codes are
    bit-packed into uint32 words along the channel axis so comparisons
    run as XOR + popcount;
  * Compare: FFT phase correlation estimates the candidate column shift
    (replacing the vendored log-polar matcher, fftm.cpp:260 — only the
    translation estimate is consumed, LidarIris.cpp:26-37), then a masked
    Hamming distance over shift+-2, forward and 180-degree-flipped
    (matchNum=2, :22-54, GetHammingDistance :164-193). Comparison against
    the whole keyframe database is one batched (vmapped) call instead of
    the reference's sequential scan (LoopClosureDetector.cpp:129-154).

Iris constructor parameters are the reference's hardcoded values
(LoopClosureDetector.cpp:27-33): nscale=4, minWaveLength=18, mult=2.1,
sigmaOnf=0.75, matchNum=2.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["iris_image", "log_gabor_filters", "iris_feature",
           "compare_batch", "compare_batch_packed", "ROWS", "COLS",
           "NSCALE", "PACKED_WORDS"]

ROWS = 80
COLS = 360
NSCALE = 4
MIN_WAVELENGTH = 18
MULT = 2.1
SIGMA_ONF = 0.75
# T/M stacks have 2*NSCALE*ROWS = 640 rows; packed along rows into uint32.
STACK_ROWS = 2 * NSCALE * ROWS
PACKED_WORDS = STACK_ROWS // 32  # 20


@jax.jit
def iris_image(points: jax.Array, mask: jax.Array) -> jax.Array:
    """(N, 3) sensor-frame points -> (80, 360) float32 occupancy-bitmask
    image (values 0..255), matching reference GetIris (LidarIris.cpp:4-19).
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    dis = jnp.sqrt(x * x + y * y)
    yaw = jnp.arctan2(y, x) * (180.0 / jnp.pi) + 180.0
    q_dis = jnp.clip(jnp.floor(dis).astype(jnp.int32), 0, ROWS - 1)
    q_arc = jnp.clip(jnp.ceil(z + 5.0).astype(jnp.int32), 0, 7)
    q_yaw = jnp.clip(jnp.floor(yaw + 0.5).astype(jnp.int32), 0, COLS - 1)
    counts = jnp.zeros((ROWS, COLS, 8), jnp.int32)
    counts = counts.at[q_dis, q_yaw, q_arc].add(mask.astype(jnp.int32))
    bits = (counts > 0).astype(jnp.float32)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.float32)
    return jnp.sum(bits * weights, axis=-1)


def log_gabor_filters() -> np.ndarray:
    """(NSCALE, COLS) real filter bank over row frequencies — numpy
    constants (reference LogGaborFilter, LidarIris.cpp:84-133). Only
    frequencies 0..COLS/2 are populated; index 0 is zeroed."""
    ndata = COLS
    radius = np.zeros(ndata // 2 + 1)
    radius[0] = 1.0
    radius[1:] = np.arange(1, ndata // 2 + 1) / float(ndata)
    filters = np.zeros((NSCALE, ndata), np.float32)
    wavelength = float(MIN_WAVELENGTH)
    for s in range(NSCALE):
        fo = 1.0 / wavelength
        lg = np.exp(-(np.log(radius / fo) ** 2) / (2.0 * np.log(SIGMA_ONF) ** 2))
        lg[0] = 0.0
        filters[s, : ndata // 2 + 1] = lg
        wavelength *= MULT
    return filters


_FILTERS = None


def _filters() -> jax.Array:
    global _FILTERS
    if _FILTERS is None:
        _FILTERS = jnp.asarray(log_gabor_filters())
    return _FILTERS


def _pack_rows(bits: jax.Array) -> jax.Array:
    """(STACK_ROWS, COLS) bool -> (PACKED_WORDS, COLS) uint32, bit j of word
    w at column c = bits[32*w + j, c]."""
    b = bits.reshape(PACKED_WORDS, 32, COLS).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, :, None]
    return jnp.sum(b << shifts, axis=1).astype(jnp.uint32)


@jax.jit
def iris_feature(img: jax.Array):
    """(80, 360) image -> (img, T_packed (20, 360) uint32, M_packed).
    reference GetFeature + LoGFeatureEncode (LidarIris.cpp:135-162).

    The reference's cv::idft omits the 1/N scale; responses here are
    multiplied by COLS so the 1e-4 magnitude threshold keeps its meaning.
    """
    spec = jnp.fft.fft(img.astype(jnp.complex64), axis=1)         # (80, 360)
    filt = _filters().astype(jnp.complex64)                        # (4, 360)
    resp = jnp.fft.ifft(spec[None, :, :] * filt[:, None, :], axis=2) * COLS
    re, im = jnp.real(resp), jnp.imag(resp)                        # (4, 80, 360)
    mag = jnp.sqrt(re * re + im * im)
    # Tlist order: [re>0 per scale, im>0 per scale] (reference :141-151)
    T = jnp.concatenate([re > 0, im > 0], axis=0).reshape(STACK_ROWS, COLS)
    M_half = mag < 1e-4
    M = jnp.concatenate([M_half, M_half], axis=0).reshape(STACK_ROWS, COLS)
    return img, _pack_rows(T), _pack_rows(M)


def _phase_corr_shift(fa: jax.Array, fb_conj: jax.Array) -> jax.Array:
    """Column shift aligning image b to image a via 2-D phase correlation
    (replaces fftm FFTMatch; only the x-translation is used)."""
    cross = fa * fb_conj
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    corr = jnp.real(jnp.fft.ifft2(cross))
    flat = jnp.argmax(corr.reshape(-1))
    dx = (flat % COLS).astype(jnp.int32)
    # map to signed shift in [-180, 180)
    return jnp.where(dx >= COLS // 2, dx - COLS, dx)


def _roll_cols(a: jax.Array, shift: jax.Array) -> jax.Array:
    return jnp.roll(a, shift, axis=-1)


def _popcount_sum(x: jax.Array) -> jax.Array:
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32))


def _hamming_over_shifts(T1, M1, T2, M2, scale_shift):
    """Masked Hamming distance minimized over shift in [scale-2, scale+2]
    (reference GetHammingDistance, LidarIris.cpp:164-193)."""
    total_cells = STACK_ROWS * COLS

    def one(off):
        s = scale_shift + off
        T1s = _roll_cols(T1, s)
        M1s = _roll_cols(M1, s)
        mask = M1s | M2
        masked_bits = _popcount_sum(mask)
        total = total_cells - masked_bits
        diff = _popcount_sum((T1s ^ T2) & ~mask)
        dis = diff.astype(jnp.float32) / jnp.maximum(total, 1).astype(jnp.float32)
        return jnp.where(total == 0, jnp.inf, dis), s

    dists, shifts = jax.vmap(one)(jnp.arange(-2, 3, dtype=jnp.int32))
    best = jnp.argmin(dists)
    return dists[best], shifts[best]


def _compare_one(q_img_fft, qT, qM, d_img, dT, dM):
    """matchNum=2 comparison: forward + 180-degree flip (reference
    Compare, LidarIris.cpp:22-54). Returns (distance, bias)."""
    # Forward: estimate shift of query within candidate.
    fd = jnp.fft.fft2(d_img.astype(jnp.complex64))
    s1 = _phase_corr_shift(fd, jnp.conj(q_img_fft))
    dis1, b1 = _hamming_over_shifts(qT, qM, dT, dM, s1)

    # Reverse: candidate flipped by 180 columns.
    d_img_x = _roll_cols(d_img, 180)
    dTx = _roll_cols(dT, 180)
    dMx = _roll_cols(dM, 180)
    fdx = jnp.fft.fft2(d_img_x.astype(jnp.complex64))
    s2 = _phase_corr_shift(fdx, jnp.conj(q_img_fft))
    dis2, b2 = _hamming_over_shifts(qT, qM, dTx, dMx, s2)

    use1 = dis1 < dis2
    return jnp.where(use1, dis1, dis2), jnp.where(use1, b1, (b2 + 180) % 360)


@jax.jit
def compare_batch(q_img, qT, qM, db_img, dbT, dbM, db_valid):
    """Compare one query feature against a padded DB batch.
    Returns (distances (K,), biases (K,)); invalid slots get +inf."""
    qf = jnp.fft.fft2(q_img.astype(jnp.complex64))
    dists, biases = jax.vmap(lambda di, dt, dm: _compare_one(qf, qT, qM, di, dt, dm))(
        db_img, dbT, dbM)
    return jnp.where(db_valid, dists, jnp.inf), biases


@jax.jit
def compare_batch_packed(q_img, qT, qM, db_img, dbT, dbM, db_valid):
    """compare_batch with one (K, 2) f32 output [distance | bias] so the
    host fetches results in a single transfer (biases < 360 are exact in
    f32)."""
    dists, biases = compare_batch(q_img, qT, qM, db_img, dbT, dbM, db_valid)
    return jnp.stack([dists, biases.astype(jnp.float32)], axis=1)
