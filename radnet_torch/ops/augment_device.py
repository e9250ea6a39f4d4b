"""Batched photometric augmentation of uint8 canvases on the device.

Brightness shift at p = 0.5, then at p = 0.5 one of {salt-and-pepper,
gaussian noise, poisson noise, intensity rescale} picked uniformly, each
sample on its own; background (zero) pixels stay zero.  The probabilities,
ranges and rounding are the JAX package's ``ops/augment_device.py``.

Every random value except the Poisson samples comes in as a
:class:`PhotometricDraws`, drawn by :func:`draw_photometric` from a
``torch.Generator`` (or built from a JAX key by the tests), so the ops are
deterministic functions of their inputs.  The Poisson samples are drawn
here from the generator the draws carry.  All of it is elementwise torch
work with no read back to the host.

``grey``: True runs the noise on channel 0 and copies it to every channel
(grey canvases have three equal channels); False runs it on every channel;
None picks per sample, by channel equality, and then the grey variant reads
channel 0 of the colour-shaped noise fields.
"""

from __future__ import annotations

import dataclasses

import torch

# Brightness / contrast window.
_MAX_B, _MIN_B = 180.0, 75.0


@dataclasses.dataclass
class PhotometricDraws:
    """Per-sample uniforms ``(B,)`` unless stated; fields are ``(B, H, W)``
    for grey canvases and ``(B, H, W, C)`` otherwise."""

    bright_coin: torch.Tensor
    bright_down: torch.Tensor
    bright_mag: torch.Tensor
    noise_coin: torch.Tensor
    noise_pick: torch.Tensor  # (B,) int64 in 0..3
    sp_amount: torch.Tensor  # also the gaussian mean's uniform, as in JAX
    sp_svp: torch.Tensor  # truncated standard normal on [-5, 5]
    sp_field: torch.Tensor
    gauss_var: torch.Tensor
    gauss_field: torch.Tensor  # standard normal
    contrast_lo: torch.Tensor
    contrast_hi: torch.Tensor
    poisson_generator: torch.Generator | None = None

    def to(self, device) -> "PhotometricDraws":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if isinstance(getattr(self, f.name), torch.Tensor)})


def grey_mode(config) -> bool | None:
    """True / False when every image type a run can draw agrees on being
    grey, else None (detect per sample)."""
    types = list(config.img_types) if config.use_img_type else list(config.img_types[:1])
    flags = ["grey" in t for t in types] or [False]
    return flags[0] if all(f == flags[0] for f in flags) else None


def draw_photometric(gen: torch.Generator, b: int, h: int, w: int, c: int, grey: bool | None,
                     device) -> PhotometricDraws:
    """One batch's draws from ``gen`` (a generator on ``device``)."""
    field = (b, h, w) if grey is True else (b, h, w, c)

    def u(shape=(b,)):
        return torch.rand(shape, generator=gen, device=device)

    svp = torch.empty(b, device=device)
    torch.nn.init.trunc_normal_(svp, 0.0, 1.0, -5.0, 5.0, generator=gen)
    return PhotometricDraws(
        bright_coin=u(), bright_down=u(), bright_mag=u(), noise_coin=u(),
        noise_pick=torch.randint(0, 4, (b,), generator=gen, device=device),
        sp_amount=u(), sp_svp=svp, sp_field=u(field), gauss_var=u(),
        gauss_field=torch.randn(field, generator=gen, device=device),
        contrast_lo=u(), contrast_hi=u(), poisson_generator=gen,
    )


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _brightness(img: torch.Tensor, d: PhotometricDraws) -> torch.Tensor:
    """Shift weighted by the current brightness, applied only while the
    foreground's mean lies inside the window; floors like a uint8 cast."""
    dims = tuple(range(1, img.dim()))
    background = img == 0
    n_fg = (~background).sum(dims).clamp_min(1)
    # Integer-valued pixels: the exact sum, rounded once to float32.
    avg = img.to(torch.int32).sum(dims).float() / n_fg.float()
    p = (avg - _MIN_B) / (_MAX_B - _MIN_B)
    down = d.bright_down < p
    delta = torch.where(down, -d.bright_mag * (avg - _MIN_B), d.bright_mag * (_MAX_B - avg))
    out = torch.floor((img + _bcast(delta, img)).clamp(0.0, 255.0))
    out = torch.where(background, torch.zeros((), device=img.device), out)
    inside = (avg > _MIN_B) & (avg < _MAX_B)
    return torch.where(_bcast(inside, img), out, img)


def _contrast(img: torch.Tensor, d: PhotometricDraws) -> torch.Tensor:
    """Random intensity rescale; truncates like a plain uint8 cast."""
    lo = _bcast(_MIN_B * d.contrast_lo, img)
    hi = _bcast((255.0 - _MAX_B) * d.contrast_hi + _MAX_B, img)
    out = ((img - lo) / (hi - lo).clamp_min(1e-6)).clamp(0.0, 1.0) * 255.0
    return torch.floor(out)


def _noise_variants(x: torch.Tensor, d: PhotometricDraws, sp_field, gauss_field) -> torch.Tensor:
    """(3, B, ...) salt-and-pepper, gaussian and poisson versions of ``x`` in [0, 1]."""
    amount = _bcast((0.3 - 0.01) * d.sp_amount + 0.01, x)
    svp = _bcast(d.sp_svp * 0.1 + 0.5, x)
    one, zero = torch.ones((), device=x.device), torch.zeros((), device=x.device)
    sp = torch.where(sp_field < amount * svp, one, torch.where(sp_field < amount, zero, x))

    mean = _bcast(0.1 * d.sp_amount - 0.05, x)
    var = _bcast((0.01 - 0.001) * d.gauss_var + 0.001, x)
    gauss = x + gauss_field * torch.sqrt(var) + mean

    # Scale by the occupied uint8 bins, rounded up to a power of two: a
    # scatter over 256 bins, with no read back of their count.
    b = x.shape[0]
    bins = torch.round(x * 255.0).to(torch.int64).reshape(b, -1).clamp(0, 255)
    occupied = torch.zeros((b, 256), device=x.device).scatter_(1, bins, 1.0)
    n_unique = occupied.sum(1).clamp_min(2.0)
    vals = _bcast(torch.exp2(torch.ceil(torch.log2(n_unique))), x)
    poisson = torch.poisson(x * vals, generator=d.poisson_generator) / vals
    return torch.stack([sp, gauss, poisson])


def _noise_one_of_four(img: torch.Tensor, d: PhotometricDraws, grey: bool | None) -> torch.Tensor:
    pick = d.noise_pick

    def variant(as_grey: bool):
        if as_grey:
            plane = img[..., 0]
            sp_f = d.sp_field if d.sp_field.dim() == 3 else d.sp_field[..., 0]
            g_f = d.gauss_field if d.gauss_field.dim() == 3 else d.gauss_field[..., 0]
        else:
            plane, sp_f, g_f = img, d.sp_field, d.gauss_field
        background = plane == 0
        cands = _noise_variants(plane / 255.0, d, sp_f, g_f)
        idx = (pick % 3).reshape((1, -1) + (1,) * (plane.dim() - 1)).expand((1,) + plane.shape)
        noisy = torch.gather(cands, 0, idx)[0]
        noisy = torch.round(noisy.clamp(0.0, 1.0) * 255.0)
        noisy = torch.where(background, torch.zeros((), device=img.device), noisy)
        if as_grey:
            noisy = noisy[..., None].expand(img.shape)
        return noisy

    if grey is None:
        is_grey = ((img[..., 0] == img[..., 1]) & (img[..., 1] == img[..., 2])).flatten(1).all(1)
        noisy = torch.where(_bcast(is_grey, img), variant(True), variant(False))
    else:
        noisy = variant(grey)
    return torch.where(_bcast(pick == 3, img), _contrast(img, d), noisy)


def photometric_augment(images: torch.Tensor, d: PhotometricDraws, grey: bool | None,
                        use_brightness: bool = True, use_noise: bool = True) -> torch.Tensor:
    """uint8 ``(B, H, W, C)`` canvases -> float32 in 0..255 (integer-valued)."""
    img = images.float()
    if use_brightness:
        img = torch.where(_bcast(d.bright_coin < 0.5, img), _brightness(img, d), img)
    if use_noise:
        img = torch.where(_bcast(d.noise_coin < 0.5, img), _noise_one_of_four(img, d, grey), img)
    return img
