"""Design system: cylindrical scatterers as the action space (counterpart of
`waves_jl_tpu/designs.py`).

Designs are frozen dataclasses of tensors, registered under the JAX
package's class names for saved episodes (`utils.trees.decode_structure`).
An action has the structure of
the design it acts on, and a batch of designs or actions carries leading
batch dimensions on every leaf (a (shots, horizon) action set has leaves
of shape (shots, horizon, ...)).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .constants import AIR, DESIGN_SPEED
from .device import resolve_device
from .utils.trees import register_tree_dataclass, tree_add, tree_map, tree_scale, tree_zeros_like


class DesignAlgebra:
    """Designs as vectors: `+` and `-` with a design of the same structure
    or a scalar, `*` with a scalar or leaf by leaf with a design, `/` by a
    scalar, and `zero()`."""

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return tree_map(lambda x: x + other, self)
        return tree_add(self, other)

    __radd__ = __add__

    def __mul__(self, s):
        if isinstance(s, DesignAlgebra):
            return tree_map(torch.mul, self, s)
        return tree_scale(self, s)

    __rmul__ = __mul__

    def __sub__(self, other):
        return self + (-1.0) * other

    def __truediv__(self, s):
        return self * (1.0 / s)

    def zero(self):
        return tree_zeros_like(self)


@register_tree_dataclass
@dataclass(frozen=True)
class NoDesign(DesignAlgebra):
    """The empty design of a free-field env: no cylinders."""

    def to_vec(self, device=None) -> torch.Tensor:
        """The empty parameter vector, float32, on `device`: the CPU unless
        given. `normalize_design` and `compute_action_cost` give none, so a
        free-field vector is an empty CPU tensor there."""
        return torch.zeros((0,), dtype=torch.float32, device=device)


@register_tree_dataclass
@dataclass(frozen=True)
class Cylinders(DesignAlgebra):
    """M cylinders: pos (..., M, 2), radii r (..., M), speed c (..., M)."""

    pos: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor

    def to_vec(self) -> torch.Tensor:
        batch = self.r.shape[:-1]
        return torch.cat([self.pos.reshape(*batch, -1), self.r, self.c], dim=-1)


@register_tree_dataclass
@dataclass(frozen=True)
class AdjustableRadiiScatterers(DesignAlgebra):
    cylinders: Cylinders

    def to_vec(self) -> torch.Tensor:
        return self.cylinders.r


@register_tree_dataclass
@dataclass(frozen=True)
class AdjustablePositionScatterers(DesignAlgebra):
    cylinders: Cylinders

    def to_vec(self) -> torch.Tensor:
        return self.cylinders.pos.reshape(*self.cylinders.r.shape[:-1], -1)


@register_tree_dataclass
@dataclass(frozen=True)
class Cloak(DesignAlgebra):
    """Adjustable ring + static core."""

    config: AdjustableRadiiScatterers
    core: Cylinders

    def to_vec(self) -> torch.Tensor:
        return self.config.to_vec()


def stack_cylinders(c1: Cylinders, c2: Cylinders) -> Cylinders:
    return Cylinders(
        pos=torch.cat([c1.pos, c2.pos], dim=-2),
        r=torch.cat([c1.r, c2.r], dim=-1),
        c=torch.cat([c1.c, c2.c], dim=-1),
    )


def design_cylinders(design) -> Cylinders | None:
    """Flatten any design to one Cylinders config (None for no design)."""
    if isinstance(design, NoDesign) or design is None:
        return None
    if isinstance(design, Cylinders):
        return design
    if isinstance(design, Cloak):
        return stack_cylinders(design.config.cylinders, design.core)
    if isinstance(design, (AdjustableRadiiScatterers, AdjustablePositionScatterers)):
        return design.cylinders
    raise TypeError(f"unsupported design {type(design)}")


def location_mask(cyls: Cylinders, grid: torch.Tensor) -> torch.Tensor:
    """(nx, ny, M) mask of the grid points inside each cylinder."""
    d2 = torch.sum((grid[:, :, None, :] - cyls.pos[None, None, :, :]) ** 2, dim=-1)
    return d2 < (cyls.r**2)[None, None, :]


def cylinders_speed(cyls: Cylinders, grid: torch.Tensor, ambient_speed) -> torch.Tensor:
    """Wavespeed field over grid (nx, ny, 2): ambient where no cylinder
    covers a point, else the sum of the covering cylinders' speeds."""
    mask = location_mask(cyls, grid).to(grid.dtype)
    ambient = (torch.sum(mask, dim=-1) == 0).to(grid.dtype) * ambient_speed
    return ambient + torch.sum(mask * cyls.c[None, None, :], dim=-1)


def speed(design, grid: torch.Tensor, ambient_speed):
    cyls = design_cylinders(design)
    if cyls is None:
        return torch.as_tensor(ambient_speed, dtype=torch.float32, device=grid.device)
    return cylinders_speed(cyls, grid, ambient_speed)


@dataclass(frozen=True)
class DesignSpace:
    """Box-constrained design space: apply = clamp(design + action, low, high)."""

    low: object
    high: object

    def __call__(self, design, action):
        return tree_map(lambda d, a, lo, hi: torch.minimum(torch.maximum(d + a, lo), hi),
                        design, action, self.low, self.high)

    def sample(self, generator: torch.Generator, batch: tuple = ()):
        """Uniform draw inside the box, with leading `batch` dimensions."""
        def draw(lo, hi):
            u = torch.rand((*batch, *lo.shape), generator=generator,
                           device=lo.device, dtype=lo.dtype)
            return u * (hi - lo) + lo

        return tree_map(draw, self.low, self.high)


def build_action_space(design, scale: float) -> DesignSpace:
    """+-scale on the adjustable components, zero bounds elsewhere."""
    def zeros(x):
        return torch.zeros_like(x)

    def full(x, v):
        return torch.full_like(x, v)

    if isinstance(design, NoDesign):
        return DesignSpace(NoDesign(), NoDesign())
    if isinstance(design, Cylinders):
        return DesignSpace(tree_map(lambda x: full(x, -scale), design),
                           tree_map(lambda x: full(x, scale), design))
    if isinstance(design, AdjustableRadiiScatterers):
        cy = design.cylinders
        return DesignSpace(
            AdjustableRadiiScatterers(Cylinders(zeros(cy.pos), full(cy.r, -scale), zeros(cy.c))),
            AdjustableRadiiScatterers(Cylinders(zeros(cy.pos), full(cy.r, scale), zeros(cy.c))),
        )
    if isinstance(design, AdjustablePositionScatterers):
        cy = design.cylinders
        return DesignSpace(
            AdjustablePositionScatterers(Cylinders(full(cy.pos, -scale), zeros(cy.r), zeros(cy.c))),
            AdjustablePositionScatterers(Cylinders(full(cy.pos, scale), zeros(cy.r), zeros(cy.c))),
        )
    if isinstance(design, Cloak):
        inner = build_action_space(design.config, scale)
        core = tree_map(zeros, design.core)
        return DesignSpace(Cloak(inner.low, core), Cloak(inner.high, core))
    raise TypeError(f"unsupported design {type(design)}")


@dataclass(frozen=True)
class DesignInterpolator:
    """Linear interpolation between two designs over [ti, tf]: t -> design."""

    initial: object
    final: object
    ti: float
    tf: float

    def __call__(self, t):
        w = lerp_weight(t, self.ti, self.tf)
        return tree_map(lambda a, b: a + w * (b - a), self.initial, self.final)


def lerp_weight(t, ti, tf) -> float:
    """(clip(t, ti, tf) - ti) / (tf - ti) in float32, 1 in place of an empty
    window; the fused kernel computes the same expression on the card."""
    t, ti, tf = np.float32(t), np.float32(ti), np.float32(tf)
    span = tf - ti
    span = span if span > 0 else np.float32(1.0)
    return float((min(max(t, ti), tf) - ti) / span)


def multi_design_interpolation(interps: list, t):
    """The design at time t of consecutive windows' interpolators: the first
    whose [ti, tf] holds t, else the one with the nearest end (on the
    host)."""
    tf = float(t)
    for interp in interps:
        if interp.ti <= tf <= interp.tf:
            return interp(t)
    best = min(interps, key=lambda it: min(abs(tf - it.ti), abs(tf - it.tf)))
    return best(t)


@dataclass(frozen=True)
class SpeedField:
    """t -> rasterised wavespeed field of the interpolated design."""

    interp: DesignInterpolator
    grid: torch.Tensor
    c0: float

    def __call__(self, t):
        return speed(self.interp(t), self.grid, self.c0)


def normalize_design(design, space: DesignSpace) -> torch.Tensor:
    """Scale the design's parameter vector into [-1, 1]."""
    lo = space.low.to_vec()
    hi = space.high.to_vec()
    return 2.0 * (design.to_vec() - lo) / (hi - lo + 1e-3) - 1.0


def design_with_vec(template, v: torch.Tensor):
    """Inverse of `to_vec`: a copy of `template` with its adjustable
    parameter vector replaced by `v`, laid out as `to_vec` gives it (the
    one-shot policy turns its output vector into an action with it). `v`
    may carry leading batch dimensions that the template's leaves lack."""
    if isinstance(template, NoDesign):
        return template
    if isinstance(template, Cylinders):
        m = template.r.shape[-1]
        batch = v.shape[:-1]
        return dataclasses.replace(template, pos=v[..., :2 * m].reshape(*batch, m, 2),
                                   r=v[..., 2 * m:3 * m], c=v[..., 3 * m:])
    if isinstance(template, AdjustableRadiiScatterers):
        return dataclasses.replace(
            template, cylinders=dataclasses.replace(template.cylinders, r=v))
    if isinstance(template, AdjustablePositionScatterers):
        return dataclasses.replace(
            template, cylinders=dataclasses.replace(template.cylinders,
                                                    pos=v.reshape(*v.shape[:-1], -1, 2)))
    if isinstance(template, Cloak):
        return dataclasses.replace(template, config=design_with_vec(template.config, v))
    raise TypeError(f"unsupported design {type(template)}")


def to_vec(design) -> torch.Tensor:
    return design.to_vec()


def design_to_circles(design) -> list:
    """(x, y, r) of each cylinder of a design, on the host, for drawing."""
    cyls = design_cylinders(design)
    if cyls is None:
        return []
    pos = cyls.pos.detach().cpu().numpy()
    r = cyls.r.detach().cpu().numpy()
    return [(float(pos[i, 0]), float(pos[i, 1]), float(r[i])) for i in range(len(r))]


def hexagon_ring(r: float, device) -> torch.Tensor:
    """(6, 2) hexagon vertex positions."""
    ang = torch.arange(6, dtype=torch.float32, device=device) * 2.0 * math.pi / 6.0
    return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], dim=1)


def build_2d_rotation_matrix(theta_deg: float, device) -> torch.Tensor:
    a = torch.tensor(theta_deg * math.pi / 180.0, dtype=torch.float32)
    return torch.tensor([[torch.cos(a), -torch.sin(a)], [torch.sin(a), torch.cos(a)]],
                        dtype=torch.float32, device=device)


def build_radii_design_space(pos: torch.Tensor) -> DesignSpace:
    """Cloak with adjustable radii in [0.2, 1.0] at speed 3 x AIR and a
    static core of radius 2 at (5, 0)."""
    m = pos.shape[0]
    dev = pos.device
    c = torch.full((m,), DESIGN_SPEED, dtype=torch.float32, device=dev)
    core = Cylinders(
        pos=torch.tensor([[5.0, 0.0]], dtype=torch.float32, device=dev),
        r=torch.tensor([2.0], dtype=torch.float32, device=dev),
        c=torch.tensor([DESIGN_SPEED], dtype=torch.float32, device=dev),
    )

    def ring(radius):
        return AdjustableRadiiScatterers(
            Cylinders(pos, torch.full((m,), radius, dtype=torch.float32, device=dev), c))

    return DesignSpace(Cloak(ring(0.2), core), Cloak(ring(1.0), core))


def build_triple_ring_design_space(device="cuda") -> DesignSpace:
    """18 cylinders on three hexagonal rings (3.5; 4.75 turned 30 degrees;
    6.0) centred at (5, 0)."""
    dev = resolve_device(device)
    rot = build_2d_rotation_matrix(30.0, dev)
    rings = torch.cat([hexagon_ring(3.5, dev), hexagon_ring(4.75, dev) @ rot,
                       hexagon_ring(6.0, dev)], dim=0)
    pos = rings + torch.tensor([5.0, 0.0], dtype=torch.float32, device=dev)
    return build_radii_design_space(pos)


def build_simple_radii_design_space(device="cuda") -> DesignSpace:
    """One adjustable cylinder at the origin, radius in [0.2, 1.0], and a
    static core of radius 2 at (5, 0), both at the speed of AIR."""
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    c = f32([AIR])
    core = Cylinders(pos=f32([[5.0, 0.0]]), r=f32([2.0]), c=f32([AIR]))

    def cloak(radius):
        return Cloak(AdjustableRadiiScatterers(Cylinders(f32([[0.0, 0.0]]), f32([radius]), c)),
                     core)

    return DesignSpace(cloak(0.2), cloak(1.0))


def build_rectangular_grid(nx: int, ny: int, r: float, device="cuda") -> torch.Tensor:
    """(nx ny, 2) positions of an nx x ny grid of pitch 2 r centred on the
    origin, x varying slowest."""
    dev = resolve_device(device)
    xs = torch.arange(nx, dtype=torch.float32, device=dev) * 2.0 * r
    ys = torch.arange(ny, dtype=torch.float32, device=dev) * 2.0 * r
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    pos = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    return pos - torch.mean(pos, dim=0, keepdim=True)


def build_rectangular_grid_design_space(device="cuda") -> DesignSpace:
    """A 5 x 5 grid of cylinders of pitch 2.2 with adjustable radii in
    [0.2, 1.0] at speed 3 x AIR, no core."""
    pos = build_rectangular_grid(5, 5, 1.0 + 0.1, device)
    m = pos.shape[0]
    c = torch.full((m,), DESIGN_SPEED, dtype=torch.float32, device=pos.device)

    def grid(radius):
        return AdjustableRadiiScatterers(
            Cylinders(pos, torch.full((m,), radius, dtype=torch.float32, device=pos.device), c))

    return DesignSpace(grid(0.2), grid(1.0))
