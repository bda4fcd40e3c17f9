"""``declare variant`` for the port: a copy of ``repro.core.variant``
(pure Python) bound to the port's own context
(``repro_torch.core.context``), since ``repro``'s imports JAX.

OpenMP 5.1 semantics:

* A *base function* is registered with ``@declare_target``.  Calling it
  resolves the best-matching *variant* for the current
  ``TargetContext``, falling back to the base implementation, as in
  Listing 4 of the paper, where the base ``atomic_inc`` raises "target
  dependent implementation missing" and ``declare variant`` bodies
  supply the nvptx/amdgcn versions.

* ``match(device=..., implementation=...)`` builds a context selector
  from trait selectors ``arch(...)``, ``isa(...)``, ``kind(...)`` and
  ``vendor(...)``.  A selector with several properties requires all of
  them (the OpenMP rule); the paper's ``match_any`` extension relaxes
  that to any, and ``match_none`` to none.

* **Scoring** follows OpenMP 5.1 §7.2: each matched trait contributes
  2^p, p its position in the ordering vendor < kind < arch < isa; the
  highest score wins, and a tie goes to the later registration.

Dispatch runs on the host when a kernel is built
(``core/build.py`` asks ``compiler_params`` for the nvcc flags of the
active context), so it costs the kernel nothing, as the paper's
link-time resolution of variants does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import context as ctx_mod

__all__ = [
    "declare_target", "declare_variant", "match", "arch", "isa", "kind",
    "vendor", "extension", "VariantError", "base_registry",
]


class VariantError(RuntimeError):
    """Raised when the base function is the paper's 'missing impl' stub."""


# ---------------------------------------------------------------------------
# Trait selectors
# ---------------------------------------------------------------------------

# Selector-set ordering for scoring (OpenMP orders them within the
# context selector; higher index = higher significance power).
_TRAIT_ORDER = ("vendor", "kind", "arch", "isa")


@dataclasses.dataclass(frozen=True)
class TraitSelector:
    trait: str                       # "arch" | "isa" | "kind" | "vendor"
    values: Tuple[str, ...]

    def matches(self, tc: ctx_mod.TargetContext, *, any_mode: bool) -> bool:
        actual = self._actual(tc)
        if actual is None:
            return False
        if any_mode:
            return actual in self.values
        # OpenMP default: every listed property must be in the context.
        # A scalar context trait can only contain one value, so "all"
        # semantics require the selector to list exactly that one value.
        return set(self.values) == {actual}

    def _actual(self, tc: ctx_mod.TargetContext) -> Optional[str]:
        if self.trait == "arch":
            return tc.device.arch
        if self.trait == "isa":
            return tc.device.isa
        if self.trait == "kind":
            return tc.device.kind
        if self.trait == "vendor":
            return tc.implementation.vendor
        raise ValueError(f"unknown trait {self.trait}")

    @property
    def score_bit(self) -> int:
        return 1 << _TRAIT_ORDER.index(self.trait)


def arch(*values: str) -> TraitSelector:
    return TraitSelector("arch", tuple(values))


def isa(*values: str) -> TraitSelector:
    return TraitSelector("isa", tuple(values))


def kind(*values: str) -> TraitSelector:
    return TraitSelector("kind", tuple(values))


def vendor(*values: str) -> TraitSelector:
    return TraitSelector("vendor", tuple(values))


def extension(name: str) -> str:
    """``implementation={extension(match_any)}`` — returns the marker."""
    if name not in ("match_any", "match_none"):
        raise ValueError(f"unsupported extension {name!r}")
    return name


@dataclasses.dataclass(frozen=True)
class Matcher:
    selectors: Tuple[TraitSelector, ...]
    ext: Optional[str] = None        # None (default "all"), match_any, match_none

    def matches(self, tc: ctx_mod.TargetContext) -> bool:
        any_mode = self.ext == "match_any"
        results = [s.matches(tc, any_mode=any_mode) for s in self.selectors]
        ok = all(results)
        if self.ext == "match_none":
            # paper extension: match when NO listed property matches.
            none_hit = not any(
                s.matches(tc, any_mode=True) for s in self.selectors)
            return none_hit
        return ok

    def score(self) -> int:
        # OpenMP 5.1 scoring: sum of 2^position over matched selectors.
        return sum(s.score_bit for s in self.selectors)


def match(*, device: Optional[Sequence[TraitSelector] | TraitSelector] = None,
          implementation: Optional[Sequence[str] | str] = None) -> Matcher:
    sels: List[TraitSelector] = []
    if device is not None:
        if isinstance(device, TraitSelector):
            sels.append(device)
        else:
            sels.extend(device)
    ext = None
    if implementation is not None:
        impls = [implementation] if isinstance(implementation, str) else list(implementation)
        exts = {extension(e) for e in impls}
        if len(exts) > 1:
            # match_any and match_none contradict each other; refuse
            # instead of silently keeping whichever was listed last.
            raise ValueError(
                f"conflicting implementation extensions {sorted(exts)}; "
                "a selector takes at most one of match_any/match_none")
        ext = exts.pop() if exts else None
    return Matcher(tuple(sels), ext)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Variant:
    matcher: Matcher
    fn: Callable
    order: int


class BaseFunction:
    """The ``declare target`` base function plus its variants."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.base = fn
        self.name = name or fn.__name__
        self.variants: List[_Variant] = []
        functools.update_wrapper(self, fn)

    def register(self, matcher: Matcher, fn: Callable) -> None:
        self.variants.append(_Variant(matcher, fn, len(self.variants)))

    def resolve(self, tc: Optional[ctx_mod.TargetContext] = None) -> Callable:
        tc = tc or ctx_mod.current_context()
        best: Optional[_Variant] = None
        best_key = (-1, -1)
        for v in self.variants:
            if v.matcher.matches(tc):
                key = (v.matcher.score(), v.order)
                if key > best_key:
                    best, best_key = v, key
        return best.fn if best is not None else self.base

    def __call__(self, *args, **kwargs):
        return self.resolve()(*args, **kwargs)

    def variant_for(self, arch_name: str) -> Callable:
        with ctx_mod.target(arch_name):
            return self.resolve()


base_registry: Dict[str, BaseFunction] = {}


def declare_target(fn: Callable = None, *, name: str = None):
    """Register ``fn`` as a base function (the portable/common part).

    The body may raise :class:`VariantError` to reproduce the paper's
    "fallback version which raises a compilation error" idiom.
    """
    def wrap(f):
        bf = BaseFunction(f, name)
        base_registry[bf.name] = bf
        return bf
    if fn is not None:
        return wrap(fn)
    return wrap


def declare_variant(base: BaseFunction, *, match: Matcher):  # noqa: A002
    """``#pragma omp begin declare variant match(...)`` as a decorator."""
    if not isinstance(base, BaseFunction):
        raise TypeError("declare_variant needs the @declare_target base function")
    def wrap(f):
        base.register(match, f)
        return f
    return wrap
