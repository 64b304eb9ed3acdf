"""Device-side data augmentation — batched tensor ops on the images' device.

Counterpart of ``spef_tpu.data.augment``: the yaw-axis homography warp that
updates both the image and the pose, brightness / contrast, Gaussian noise,
Gaussian blur and color jitter, and ``train_augment``, the train-transform
stack (yaw rotation, blur, jitter).  Images are float NHWC in [0, 1].

Each transform is two parts: ``draw_*`` takes its random values from an
explicit ``torch.Generator`` (on the images' device: a CUDA generator on
the card), ``apply_*`` takes those values and is deterministic, so the
tests can feed it the values JAX drew.  ``yaw_rotation_augment`` and the
other JAX names do both.

The warp samples bilinearly in pixel coordinates with zero for each of the
four taps that falls outside the image, JAX's rule, as a flat gather
(``torch.gather`` over the H*W rows of each image).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from spef_tpu_torch.data.camera import Camera
from spef_tpu_torch.pose.rotations import dcm2quat, euler2dcm, multiply_quaternions
from spef_tpu_torch.utils import profiling

__all__ = [
    "yaw_rotation_augment", "draw_yaw_rotation", "apply_yaw_rotation",
    "brightness_contrast", "draw_brightness_contrast", "apply_brightness_contrast",
    "gaussian_noise", "draw_gaussian_noise", "apply_gaussian_noise",
    "gaussian_blur", "draw_gaussian_blur", "apply_gaussian_blur",
    "color_jitter", "draw_color_jitter", "apply_color_jitter",
    "train_augment",
]


def _uniform(generator: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0
             ) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _bilinear_sample(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) images at float pixel coordinates (B, H', W');
    each tap outside the image is zero."""
    b, h, w, c = images.shape
    flat = images.reshape(b, h * w, c)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        vals = vals.reshape(*idx.shape, c)
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    top = gather(y0, x0) * (1 - dx) + gather(y0, x0 + 1) * dx
    bot = gather(y0 + 1, x0) * (1 - dx) + gather(y0 + 1, x0 + 1) * dx
    return top * (1 - dy) + bot * dy


# ---------------------------------------------------------------------------
# Yaw rotation (image and pose)
# ---------------------------------------------------------------------------


def draw_yaw_rotation(generator: torch.Generator, batch: int, rot_probability: float = 0.5,
                      rot_max_magnitude: float = 50.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(apply (B,) bool, angle (B,) degrees): each sample rotated with
    probability ``rot_probability`` by a uniform angle in
    [-rot_max_magnitude, rot_max_magnitude], 0 where not applied."""
    apply = _uniform(generator, (batch,)) < rot_probability
    deg = (_uniform(generator, (batch,)) - 0.5) * 2.0 * rot_max_magnitude
    return apply, torch.where(apply, deg, torch.zeros_like(deg))


def apply_yaw_rotation(images: torch.Tensor, ori: torch.Tensor, pos: torch.Tensor,
                       camera: Camera, apply: torch.Tensor, deg: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp each image by K_s R K_s^-1 (K scaled to the image size, R the
    yaw rotation by ``deg``) and rotate its pose: ori' = q(R) * ori,
    pos' = R @ pos, where ``apply``."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    zeros = torch.zeros_like(deg)
    r_change = euler2dcm(torch.stack([deg, zeros, zeros], dim=-1))  # (B, 3, 3)

    k_full = torch.tensor(camera.K, dtype=torch.float32, device=dev)
    scale = torch.tensor([[w / camera.nu, 0, 0], [0, h / camera.nv, 0], [0, 0, 1]],
                         dtype=torch.float32, device=dev)
    k_s = scale @ k_full
    k_s_inv = torch.linalg.inv(k_s)
    # A warp gathers source pixels at H^-1 @ dst; H = K R K^-1, so
    # H^-1 = K R^T K^-1 (R orthonormal).
    h_inv = k_s @ r_change.transpose(-1, -2) @ k_s_inv  # (B, 3, 3)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    src = torch.einsum("bij,hwj->bhwi", h_inv, grid)
    warped = _bilinear_sample(images, src[..., 0] / src[..., 2], src[..., 1] / src[..., 2])
    images_out = torch.where(apply[:, None, None, None], warped, images)

    ori_new = multiply_quaternions(dcm2quat(r_change), ori)
    pos_new = torch.einsum("bij,bj->bi", r_change, pos)
    return (images_out, torch.where(apply[:, None], ori_new, ori),
            torch.where(apply[:, None], pos_new, pos))


def yaw_rotation_augment(generator: torch.Generator, images: torch.Tensor, ori: torch.Tensor,
                         pos: torch.Tensor, camera: Camera, rot_probability: float = 0.5,
                         rot_max_magnitude: float = 50.0):
    """Batched yaw rotation of images with the pose updated to match."""
    apply, deg = draw_yaw_rotation(generator, images.shape[0], rot_probability,
                                   rot_max_magnitude)
    return apply_yaw_rotation(images, ori, pos, camera, apply, deg)


# ---------------------------------------------------------------------------
# Photometric transforms
# ---------------------------------------------------------------------------


def draw_brightness_contrast(generator: torch.Generator, batch: int, alpha=(0.5, 2.0),
                             beta=(-25.0, 25.0)) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta), each (B, 1, 1, 1): alpha log-uniform, beta uniform / 255."""
    log_a = _uniform(generator, (batch, 1, 1, 1), math.log(alpha[0]), math.log(alpha[1]))
    b = _uniform(generator, (batch, 1, 1, 1), beta[0] / 255, beta[1] / 255)
    return torch.exp(log_a), b


def apply_brightness_contrast(images: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor
                              ) -> torch.Tensor:
    return torch.clamp(alpha * images + beta, 0.0, 1.0)


def brightness_contrast(generator: torch.Generator, images: torch.Tensor, alpha=(0.5, 2.0),
                        beta=(-25.0, 25.0)) -> torch.Tensor:
    """new = clip(a * img + b / 255), a log-uniform."""
    a, b = draw_brightness_contrast(generator, images.shape[0], alpha, beta)
    return apply_brightness_contrast(images, a, b)


def draw_gaussian_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """A standard normal field of ``shape``."""
    return torch.randn(shape, generator=generator, device=generator.device)


def apply_gaussian_noise(images: torch.Tensor, noise: torch.Tensor, std: float = 25.0 / 255
                         ) -> torch.Tensor:
    return torch.clamp(images + noise * std, 0.0, 1.0)


def gaussian_noise(generator: torch.Generator, images: torch.Tensor, std: float = 25.0 / 255
                   ) -> torch.Tensor:
    return apply_gaussian_noise(images, draw_gaussian_noise(generator, images.shape), std)


def draw_gaussian_blur(generator: torch.Generator, sigma_range=(0.1, 2.0)) -> torch.Tensor:
    """One sigma for the batch (a 0-d tensor)."""
    return _uniform(generator, (), sigma_range[0], sigma_range[1])


def apply_gaussian_blur(images: torch.Tensor, sigma: torch.Tensor, kernel_size: int = 5
                        ) -> torch.Tensor:
    """Separable Gaussian blur (horizontal, then vertical), zero padding."""
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32, device=images.device)
    k1 = torch.exp(-(xs**2) / (2 * sigma**2))
    k1 = k1 / torch.sum(k1)
    c = images.shape[-1]
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, k1.view(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size),
                 padding=(0, half), groups=c)
    x = F.conv2d(x, k1.view(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1),
                 padding=(half, 0), groups=c)
    return x.permute(0, 2, 3, 1)


def gaussian_blur(generator: torch.Generator, images: torch.Tensor, kernel_size: int = 5,
                  sigma_range=(0.1, 2.0)) -> torch.Tensor:
    """Separable Gaussian blur with one random sigma for the batch."""
    return apply_gaussian_blur(images, draw_gaussian_blur(generator, sigma_range), kernel_size)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.amax(rgb, dim=-1)
    minc = torch.amin(rgb, dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    hr = torch.remainder((g - b) / safe, 6.0)
    hg = (b - r) / safe + 2.0
    hb = (r - g) / safe + 4.0
    h = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    h = torch.where(delta == 0, zero, h)
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.to(torch.int32) % 6

    def select(*choices):  # choices[k] where i == k
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def draw_color_jitter(generator: torch.Generator, batch: int, brightness=0.2, contrast=0.2,
                      saturation=0.2, hue=0.2) -> Dict[str, torch.Tensor]:
    """The four factors: brightness, contrast and saturation (B, 1, 1, 1)
    uniform in [1 - x, 1 + x], hue (B, 1, 1) uniform in [-hue, hue]."""
    return {
        "brightness": _uniform(generator, (batch, 1, 1, 1), 1 - brightness, 1 + brightness),
        "contrast": _uniform(generator, (batch, 1, 1, 1), 1 - contrast, 1 + contrast),
        "saturation": _uniform(generator, (batch, 1, 1, 1), 1 - saturation, 1 + saturation),
        "hue": _uniform(generator, (batch, 1, 1), -hue, hue),
    }


def apply_color_jitter(images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
                       saturation: torch.Tensor, hue: torch.Tensor) -> torch.Tensor:
    """torchvision-style ColorJitter with the drawn factors."""
    img = torch.clamp(images * brightness, 0.0, 1.0)
    mean = torch.mean(img, dim=(1, 2, 3), keepdim=True)
    img = torch.clamp((img - mean) * contrast + mean, 0.0, 1.0)
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + hue, 1.0)
    s = torch.clamp(hsv[..., 1] * saturation[..., 0], 0.0, 1.0)
    img = _hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], dim=-1))
    return torch.clamp(img, 0.0, 1.0)


def color_jitter(generator: torch.Generator, images: torch.Tensor, brightness=0.2, contrast=0.2,
                 saturation=0.2, hue=0.2) -> torch.Tensor:
    """torchvision-style ColorJitter, batched."""
    return apply_color_jitter(images, **draw_color_jitter(
        generator, images.shape[0], brightness, contrast, saturation, hue))


def train_augment(generator: torch.Generator, images: torch.Tensor, ori: torch.Tensor,
                  pos: torch.Tensor, camera: Camera, rot_augment: bool = True,
                  other_augment: bool = True, rows: Optional[Tuple[int, int]] = None):
    """The train-transform stack: yaw rotation (with the pose), Gaussian
    blur, color jitter; returns (images, ori, pos).

    ``rows = (rank, size)``: the batch is rank ``rank``'s share of a global
    batch ``size`` times larger (data parallel): the values are drawn for
    the global batch and this share's rows of them applied.  While a
    profiler runs, the draws and their application are the span
    ``spef.augment``."""
    rank, size = rows or (0, 1)
    b = images.shape[0]
    share = slice(rank * b, (rank + 1) * b)
    with profiling.span("augment"):
        if rot_augment:
            apply, deg = draw_yaw_rotation(generator, b * size)
            images, ori, pos = apply_yaw_rotation(images, ori, pos, camera, apply[share],
                                                  deg[share])
        if other_augment:
            images = apply_gaussian_blur(images, draw_gaussian_blur(generator))
            jitter = draw_color_jitter(generator, b * size)
            images = apply_color_jitter(images, **{k: v[share] for k, v in jitter.items()})
    return images, ori, pos
