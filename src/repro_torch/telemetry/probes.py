"""Port of ``repro.telemetry.probes``: the QAT health probes (the name
registry is in ``repro_torch.telemetry``).

Two halves, both riding the training step's one host transfer of its
metrics, so turning probes on adds no host sync:

**Forward-pass taps.**  The quantizers and the decoupled FFN cannot return
extra values without changing every signature of the model stack, so tap
sites record into an *ambient collector*: a module global that is ``None``
except inside the training step's :func:`collect` scope.  Activation clip
rates and the decoupled branches' output norms land there.  ``active()``
is a plain Python check: outside the scope (every serving path, training
with probes off) a tap site runs no torch op at all.  Taps record values
of detached tensors, so they add nothing to the autograd graph.

Upstream's scan discipline (``scan_scope`` / ``scan_drain`` /
``scan_merge``) has no counterpart: the port's layers run in a Python
loop, and a tap inside a layer records straight into the collector.  Under
remat (``torch.utils.checkpoint``) the backward runs each layer's forward
again; the step closes its :func:`collect` scope before it asks for the
gradients, so the rerun records nothing and no value counts twice.
``models.api.loss_fn`` folds :func:`summaries` into its metrics.

**Param-side probes.**  Sign-flip rates, scale drift, INT8 weight
saturation and the per-branch gradient split are functions of (old params,
new params, grads).  The port's step updates the master in place, so
:class:`ParamProbes` takes each leaf's old statistics just before its
update and compares just after it (``optim.adamw.adamw_update``'s
``watch``), leaf by leaf: a leaf's centered-sign mask (one byte an
element) is the largest thing it holds.  :func:`train_step_probes` runs
the same code over three trees, upstream's call.  Layer families come from
tree paths (``w8_*`` 8-bit branch, ``w1*`` 1-bit trunk, ``mixer``
attention, ``embed``/``lm_head``); norm, SubLN and router leaves are
skipped.

This module imports nothing of ``repro_torch.core`` at module level (the
quantizers import it for their tap sites).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.telemetry.tracing import annotate

Tensor = torch.Tensor

_COLLECTOR: Optional["ProbeCollector"] = None


class ProbeCollector:
    """Named sums: f32 tensors for tensor values (device scalars at the
    tap sites), host floats for numbers (the weights of :func:`add_mean`).
    ``<name>_sum`` / ``<name>_w`` pairs become weighted means in
    :func:`summaries`."""

    def __init__(self):
        self.sums: dict = {}

    def add(self, name: str, value) -> None:
        if torch.is_tensor(value):
            value = value.detach().float()
        prev = self.sums.get(name)
        self.sums[name] = value if prev is None else prev + value

    def drain(self) -> dict:
        d, self.sums = self.sums, {}
        return d


def active() -> bool:
    """True inside a :func:`collect` scope: tap sites check it and do
    nothing when it is False."""
    return _COLLECTOR is not None


@contextlib.contextmanager
def collect():
    """Activate an ambient collector for the enclosed forward.  Scopes nest
    by shadowing (the inner scope wins, the outer one is restored)."""
    global _COLLECTOR
    prev = _COLLECTOR
    _COLLECTOR = ProbeCollector()
    try:
        yield _COLLECTOR
    finally:
        _COLLECTOR = prev


def add(name: str, value) -> None:
    if _COLLECTOR is not None:
        _COLLECTOR.add(name, value)


def add_mean(name: str, value, weight: float) -> None:
    """Record one term of a weighted mean (:func:`summaries` divides the
    pair); ``weight`` is a host number (an element count)."""
    if _COLLECTOR is not None:
        _COLLECTOR.add(name + "_sum", _f32(value) * weight)
        _COLLECTOR.add(name + "_w", float(weight))


def _f32(v) -> Tensor:
    return v.detach().float() if torch.is_tensor(v) else torch.tensor(float(v))


def merge(drained: Optional[dict]) -> None:
    """Re-record a drained collector's values, as they are."""
    if drained is None:
        return
    for name, v in drained.items():
        add(name, v)


def summaries() -> dict[str, Tensor]:
    """Drain the ambient collector into final named metrics:

    * ``<name>_sum`` / ``<name>_w`` pairs -> ``qat_<name>``, the weighted
      mean (the activation clip rate);
    * ``branch1_sq`` / ``branch8_sq`` -> ``qat_branch_share8`` =
      ||alpha*y8||^2 / (||alpha*y8||^2 + ||beta*y1||^2).
    """
    if _COLLECTOR is None:
        return {}
    from repro_torch.core.quantization import fdiv  # lazy: import cycle

    d = _COLLECTOR.drain()
    out: dict[str, Tensor] = {}
    for base in sorted(n[: -len("_sum")] for n in d if n.endswith("_sum")):
        out["qat_" + base] = fdiv(_f32(d[base + "_sum"]), max(d[base + "_w"], 1e-9))
    if "branch8_sq" in d and "branch1_sq" in d:
        b8, b1 = _f32(d["branch8_sq"]), _f32(d["branch1_sq"])
        out["qat_branch_share8"] = b8 / torch.clamp(b8 + b1, min=1e-20)
    return out


# ---------------------------------------------------------------------------
# Param-side probes (no taps: functions of params and grads)
# ---------------------------------------------------------------------------

#: Layer families of the per-family probes; other leaves are skipped.
FAMILIES = ("attn", "ffn1", "ffn8", "embed")


def leaf_path(path) -> str:
    """A tree path (keys and indices, ``optim.adamw.tree_paths``) ->
    "a/b/c", as upstream joins a JAX key path."""
    return "/".join(str(e) for e in path)


def family_of(key: str) -> Optional[str]:
    """Classify a parameter path into a probe family (None = skip).  Branch
    fragments win over ``mixer``, as upstream."""
    parts = key.split("/")
    if any("router" in p or "norm" in p or "subln" in p for p in parts):
        return None
    if any(p.startswith("w8") for p in parts):
        return "ffn8"
    if any(p.startswith("w1") for p in parts):
        return "ffn1"
    if "mixer" in parts:
        return "attn"
    if "embed" in parts or "lm_head" in parts:
        return "embed"
    return None


def _slice_axes(w: Tensor) -> tuple[int, ...]:
    """Per-slice reduction axes: the trailing (d_in, d_out) matrix of a
    possibly layer/expert-stacked leaf, as the fake-quant path scales each
    2-D weight."""
    return tuple(range(w.ndim - 2, w.ndim))


def _centered_sign(w: Tensor) -> Tensor:
    """The binarizer's sign grid, Sign(W - mu) per slice (paper Eq. 4), as
    a mask: True where the sign is +1.  ``w >= mu`` is ``w - mu >= 0``
    without the difference's copy (IEEE subtraction of two finite floats
    is 0 only when they are equal)."""
    return w >= torch.mean(w, dim=_slice_axes(w), keepdim=True)


def _family(path, leaf) -> Optional[str]:
    if leaf.ndim < 2 or not leaf.is_floating_point():
        return None
    return family_of(leaf_path(path))


def _family_leaves(tree):
    """Yield (family, leaf) for the classified >= 2-D float leaves of
    ``tree``, in tree order."""
    from repro_torch.optim.adamw import tree_paths  # lazy: import cycle

    for path, leaf in tree_paths(tree):
        fam = _family(path, leaf)
        if fam is not None:
            yield fam, leaf


class ParamProbes:
    """``train_step_probes`` taken leaf by leaf around an in-place update:
    ``watch(path, w, g)`` before the leaf changes, the callable it returns
    after, then :meth:`result`.  Every value stays on the device."""

    def __init__(self):
        self.flips: dict[str, Tensor] = {}
        self.counts = {f: 0 for f in FAMILIES}
        self.drift: dict[str, Tensor] = {}
        self.drift_n = {"absmean": 0, "absmax": 0}
        self.clip8_hits: Optional[Tensor] = None
        self.clip8_n = 0
        self.gsq: dict[str, Tensor] = {}

    def _acc(self, d: dict, key: str, value: Tensor) -> None:
        d[key] = value if key not in d else d[key] + value

    def watch(self, path, w: Tensor, g: Tensor) -> Optional[Callable[[Tensor], None]]:
        fam = _family(path, w)
        if fam is None:
            return None
        with annotate("train/probes"):
            return self._watch(fam, w, g)

    def _watch(self, fam: str, w: Tensor, g: Tensor) -> Callable[[Tensor], None]:
        from repro_torch.core.quantization import EPS  # lazy: import cycle

        w = w.float()
        axes = _slice_axes(w)
        sign_old = _centered_sign(w)
        n_slices = w.numel() // (w.shape[-1] * w.shape[-2])
        if fam in ("attn", "ffn1"):
            lam_old = torch.mean(torch.abs(w), dim=axes) + EPS
        elif fam == "ffn8":
            amax_old = torch.linalg.vector_norm(w, float("inf"), dim=axes)
        if fam in ("ffn1", "ffn8"):
            self._acc(self.gsq, fam, torch.sum(torch.square(g.float())))

        def after(w_new: Tensor) -> None:
            with annotate("train/probes"):
                _after(w_new.float())

        def _after(w_new: Tensor) -> None:
            self._acc(self.flips, fam, torch.count_nonzero(sign_old != _centered_sign(w_new)))
            self.counts[fam] += w_new.numel()
            if fam in ("attn", "ffn1"):
                lam_new = torch.mean(torch.abs(w_new), dim=axes) + EPS
                self._acc(self.drift, "absmean", torch.sum(torch.abs(lam_new - lam_old) / lam_old))
                self.drift_n["absmean"] += n_slices
            elif fam == "ffn8":
                from repro_torch.core.quantization import INT8_QMAX, fdiv

                amax_new = torch.linalg.vector_norm(w_new, float("inf"), dim=axes, keepdim=True)
                self._acc(self.drift, "absmax", torch.sum(
                    torch.abs(amax_new.reshape(amax_old.shape) - amax_old) / (amax_old + EPS)))
                self.drift_n["absmax"] += n_slices
                q = torch.round(w_new * fdiv(INT8_QMAX, amax_new + EPS))
                hits = torch.count_nonzero(torch.abs(q) >= INT8_QMAX)
                self.clip8_hits = hits if self.clip8_hits is None else self.clip8_hits + hits
                self.clip8_n += w_new.numel()

        return after

    def result(self) -> dict[str, Tensor]:
        """The probe metrics (f32 device scalars); the families present
        decide which keys exist:

        * ``qat_flip_<fam>``: the share of latent weights whose centered
          sign flipped;
        * ``qat_scale_drift_absmean`` / ``qat_scale_drift_absmax``: mean
          relative per-slice drift of the 1-bit lambda / 8-bit amax scales;
        * ``qat_clip_w8``: the share of 8-bit-branch weights on the INT8
          rail (|q| = 127) under the new params;
        * ``qat_gnorm_ffn8`` / ``qat_gnorm_ffn1`` / ``qat_gnorm_share8``:
          gradient norms of the two decoupled branches and the 8-bit share
          of their summed squares.
        """
        from repro_torch.core.quantization import fdiv  # lazy: import cycle

        out: dict[str, Tensor] = {}
        for fam in FAMILIES:
            if self.counts[fam]:
                out[f"qat_flip_{fam}"] = fdiv(self.flips[fam].float(), float(self.counts[fam]))
        for kind in ("absmean", "absmax"):
            if self.drift_n[kind]:
                out[f"qat_scale_drift_{kind}"] = fdiv(self.drift[kind], float(self.drift_n[kind]))
        if self.clip8_n:
            out["qat_clip_w8"] = fdiv(self.clip8_hits.float(), float(self.clip8_n))
        for fam in ("ffn8", "ffn1"):
            if fam in self.gsq:
                out[f"qat_gnorm_{fam}"] = torch.sqrt(self.gsq[fam])
        if "ffn8" in self.gsq and "ffn1" in self.gsq:
            out["qat_gnorm_share8"] = self.gsq["ffn8"] / torch.clamp(
                self.gsq["ffn8"] + self.gsq["ffn1"], min=1e-20)
        return out


def train_step_probes(old_params, new_params, grads) -> dict[str, Tensor]:
    """Every param/grad-side QAT probe of one step, from three trees
    (upstream's call); the same code as the in-place :class:`ParamProbes`."""
    from repro_torch.optim.adamw import tree_leaves, tree_paths  # lazy: import cycle

    probes = ParamProbes()
    for (path, w_old), w_new, g in zip(tree_paths(old_params), tree_leaves(new_params),
                                       tree_leaves(grads)):
        after = probes.watch(path, w_old, g)
        if after is not None:
            after(w_new)
    return probes.result()


# ---------------------------------------------------------------------------
# Cadenced democratization snapshot (host-driven, between steps)
# ---------------------------------------------------------------------------


def sensitivity_snapshot(params, max_elems: int = 1 << 20) -> dict[str, float]:
    """Democratization statistics per layer family, ``core.sensitivity``'s
    metrics with the squared latent weight as the sensitivity proxy (the
    isotropic-input OBS limit ``s ~ w^2``).

    Upstream concatenates each family's flattened ``w^2`` and takes every
    k-th element, k = ceil(size / max_elems) when the family holds more
    than ``max_elems``.  That concatenation is 4.4 GB for the 1-bit trunk
    of pquant-1.3b, so each leaf gives only the elements whose offset in
    the concatenation is a multiple of k: the same elements, in the same
    order.  One host transfer for all the values.
    """
    from repro_torch.core.sensitivity import (
        democratization_score,
        sensitivity_kurtosis,
        top_fraction_mass,
    )

    pools: dict[str, list] = {"attn": [], "ffn1": [], "ffn8": []}
    for fam, w in _family_leaves(params):
        if fam in pools:
            pools[fam].append(w)
    names, vals = [], []
    for fam, leaves in pools.items():
        if not leaves:
            continue
        total = sum(w.numel() for w in leaves)
        k = -(-total // max_elems) if total > max_elems else 1
        parts, off = [], 0
        for w in leaves:
            parts.append(torch.square(w.reshape(-1)[(-off) % k::k].float()))
            off += w.numel()
        s = torch.cat(parts)
        names += [f"demo_score_{fam}", f"demo_kurtosis_{fam}", f"demo_top1pct_{fam}"]
        vals += [democratization_score(s), sensitivity_kurtosis(s), top_fraction_mass(s, 0.01)]
    if not vals:
        return {}
    return dict(zip(names, torch.stack(vals).tolist()))
