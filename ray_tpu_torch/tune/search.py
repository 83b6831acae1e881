"""Search spaces and variant generation.

Reference analogues: `python/ray/tune/search/sample.py` (Domain/Float/
Integer/Categorical), `python/ray/tune/search/basic_variant.py`
(BasicVariantGenerator: grid expansion x num_samples with seeded random
resolution), `python/ray/tune/search/variant_generator.py`.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, List, Optional


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random):
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    """Marker consumed by the variant generator (reference format)."""
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _walk(space: Dict[str, Any], path=()):
    """Yield (path, value) for every leaf of a nested dict space."""
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set_path(d: dict, path, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def _get_path(d: dict, path):
    for k in path:
        d = d[k]
    return d


def grid_size(param_space: Dict[str, Any]) -> int:
    """Number of grid points (product of grid_search axis lengths; 1 when
    no grids)."""
    n = 1
    for _, spec in _walk(param_space):
        if _is_grid(spec):
            n *= max(len(spec["grid_search"]), 1)
    return n


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Expand grid_search axes (cartesian product) and draw
    ``num_samples`` random resolutions of the Domain leaves for each grid
    combination (reference: BasicVariantGenerator semantics)."""
    rng = random.Random(seed)
    grid_axes = [(p, v["grid_search"]) for p, v in _walk(param_space)
                 if _is_grid(v)]
    sample_leaves = [(p, v) for p, v in _walk(param_space)
                     if isinstance(v, Domain)]
    const_leaves = [(p, v) for p, v in _walk(param_space)
                    if not _is_grid(v) and not isinstance(v, Domain)]

    variants = []
    grid_values = [axis for _, axis in grid_axes]
    for combo in itertools.product(*grid_values) if grid_axes else [()]:
        for _ in range(num_samples):
            cfg: Dict[str, Any] = {}
            for p, v in const_leaves:
                _set_path(cfg, p, v)
            for (p, _), val in zip(grid_axes, combo):
                _set_path(cfg, p, val)
            for p, dom in sample_leaves:
                _set_path(cfg, p, dom.sample(rng))
            variants.append(cfg)
    return variants


# ---------------------------------------------------------------------------
# Pluggable searchers (reference: `python/ray/tune/search/searcher.py`)


class Searcher:
    """Sequential suggestion interface: the controller calls ``suggest``
    when it has capacity for a new trial and feeds results back through
    ``on_trial_result`` / ``on_trial_complete`` (reference:
    `tune/search/searcher.py` Searcher.suggest/on_trial_complete)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        # Remember what the USER set: TuneConfig's defaults must not
        # clobber an explicit constructor choice (mode='min' searchers
        # would silently maximize otherwise).
        self._mode_user_set = mode is not None
        self.mode = mode or "max"

    def set_search_properties(self, metric: Optional[str], mode: str,
                              param_space: Dict[str, Any]) -> None:
        if metric is not None and self.metric is None:
            self.metric = metric
        if mode and not self._mode_user_set:
            self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Random/grid sampling as a Searcher (reference:
    `tune/search/basic_variant.py`): grid axes are ENUMERATED round-robin
    (every grid point runs before any repeats), Domain leaves resolve
    randomly per suggestion."""

    def __init__(self, metric=None, mode: Optional[str] = None,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._rng = random.Random(seed)
        self.param_space: Dict[str, Any] = {}
        self._grid_combos: Optional[list] = None

    def suggest(self, trial_id):
        if self._grid_combos is None:
            self._flat = dict(_walk(self.param_space))
            grid = [(p, spec["grid_search"])
                    for p, spec in self._flat.items() if _is_grid(spec)]
            self._grid_paths = [p for p, _ in grid]
            self._grid_combos = list(
                itertools.product(*[vals for _, vals in grid])) or [()]
            self._i = 0
        combo = self._grid_combos[self._i % len(self._grid_combos)]
        self._i += 1
        config: Dict[str, Any] = {}
        for path, spec in self._flat.items():
            if _is_grid(spec):
                continue
            value = spec.sample(self._rng) if isinstance(spec, Domain) \
                else spec
            _set_path(config, path, value)
        for path, v in zip(self._grid_paths, combo):
            _set_path(config, path, v)
        return config


class TPESearcher(Searcher):
    """Tree-structured-Parzen-Estimator-style bayesian search (the
    method behind hyperopt/BOHB's model; reference integration point:
    `tune/search/hyperopt/hyperopt_search.py`).

    After ``n_initial_points`` random trials, completed trials split into
    the top ``gamma`` quantile ("good") and the rest ("bad"); for each
    Float/Integer dimension, candidates sampled from the domain are scored
    by the kernel-density ratio l(x)/g(x) (Parzen windows over good vs bad
    observations) and the best candidate wins.  Categorical dims use
    smoothed category-frequency ratios.  Pure numpy, no extra deps.
    """

    def __init__(self, metric=None, mode: Optional[str] = None,
                 n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self.param_space: Dict[str, Any] = {}
        self._live: Dict[str, dict] = {}
        self._history: List[tuple] = []  # (config, normalized score)

    # ------------------------------------------------------------ feedback

    def on_trial_complete(self, trial_id, result=None):
        config = self._live.pop(trial_id, None)
        if config is None or not result:
            return
        v = result.get(self.metric) if self.metric else None
        if v is None:
            return
        self._history.append(
            (config, float(v) if self.mode == "max" else -float(v)))

    # ------------------------------------------------------------- suggest

    def _kde_score(self, x: float, obs: List[float], span: float) -> float:
        import math

        if not obs:
            return 1e-12
        bw = max(span / max(len(obs) ** 0.5, 1.0), span * 0.05)
        return sum(math.exp(-0.5 * ((x - o) / bw) ** 2)
                   for o in obs) / (len(obs) * bw)

    def _suggest_dim(self, path, domain, good: list, bad: list):
        if isinstance(domain, Categorical):
            cats = domain.categories
            g_counts = {c: 1.0 for c in cats}  # +1 smoothing
            b_counts = {c: 1.0 for c in cats}
            for cfg, _ in good:
                g_counts[_get_path(cfg, path)] = \
                    g_counts.get(_get_path(cfg, path), 1.0) + 1
            for cfg, _ in bad:
                b_counts[_get_path(cfg, path)] = \
                    b_counts.get(_get_path(cfg, path), 1.0) + 1
            return max(cats, key=lambda c: g_counts[c] / b_counts[c])
        if isinstance(domain, (Float, Integer)):
            import math

            log = getattr(domain, "log", False)
            xform = (lambda v: math.log(v)) if log else (lambda v: v)
            lo, hi = xform(domain.lower), xform(domain.upper)
            span = hi - lo
            g_obs = [xform(_get_path(cfg, path)) for cfg, _ in good]
            b_obs = [xform(_get_path(cfg, path)) for cfg, _ in bad]
            best, best_score = None, -1.0
            for _ in range(self.n_candidates):
                cand = domain.sample(self._rng)
                x = xform(cand)
                ratio = (self._kde_score(x, g_obs, span)
                         / max(self._kde_score(x, b_obs, span), 1e-12))
                if ratio > best_score:
                    best, best_score = cand, ratio
            return best
        return domain.sample(self._rng)

    def suggest(self, trial_id):
        flat = dict(_walk(self.param_space))
        config: Dict[str, Any] = {}
        done = sorted(self._history, key=lambda cs: -cs[1])
        use_model = len(done) >= self.n_initial
        k = max(1, int(len(done) * self.gamma)) if use_model else 0
        good, bad = done[:k], done[k:]
        for path, spec in flat.items():
            if _is_grid(spec):
                value = self._rng.choice(spec["grid_search"])
            elif isinstance(spec, Domain):
                value = (self._suggest_dim(path, spec, good, bad)
                         if use_model else spec.sample(self._rng))
            else:
                value = spec
            _set_path(config, path, value)
        self._live[trial_id] = config
        return config


class AskTellSearcher(Searcher):
    """Adapter for external ask/tell optimizers (reference:
    `tune/search/optuna/optuna_search.py` — the integration seam the
    reference wraps Optuna/BOHB/Ax through).

    Two optimizer protocols are accepted:

    * **Optuna study**: detected by ``ask``/``tell`` + ``direction``
      attributes.  ``suggest`` calls ``study.ask(distributions)`` built
      from the Tune param_space (Float -> FloatDistribution, Integer ->
      IntDistribution, Categorical -> CategoricalDistribution) and
      completion calls ``study.tell(trial, value)``.
    * **Plain ask/tell**: any object with ``ask(param_space) -> config``
      and ``tell(config, score)`` where score is normalized so HIGHER is
      better (the adapter flips minimize-mode values).

    Sampled-domain callables (``tune.sample_from``-style) are resolved
    here either way, so the optimizer only sees concrete dimensions.
    """

    def __init__(self, optimizer, metric: Optional[str] = None,
                 mode: Optional[str] = None, n_initial_points: int = 8,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._opt = optimizer
        self._is_optuna = hasattr(optimizer, "direction") or (
            type(optimizer).__module__.startswith("optuna"))
        self._live: Dict[str, Any] = {}  # trial_id -> (handle, config)
        self.param_space: Dict[str, Any] = {}
        # the controller caps default concurrency at a model-based
        # searcher's warmup width (tune_controller.run) — expose it so an
        # unbounded budget doesn't ask for everything before any tell
        self.n_initial = n_initial_points
        self._rng = random.Random(seed)

    # ------------------------------------------------------------ optuna

    def _optuna_distributions(self):
        import optuna

        dists = {}
        for name, dom in self.param_space.items():
            if isinstance(dom, Float):
                dists[name] = optuna.distributions.FloatDistribution(
                    dom.lower, dom.upper, log=dom.log)
            elif isinstance(dom, Integer):
                dists[name] = optuna.distributions.IntDistribution(
                    dom.lower, dom.upper - 1)
            elif isinstance(dom, Categorical):
                dists[name] = optuna.distributions.CategoricalDistribution(
                    list(dom.categories))
        return dists

    # ----------------------------------------------------------- Searcher

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        fixed = {}
        for k, v in self.param_space.items():
            if isinstance(v, (Float, Integer, Categorical)):
                continue  # the optimizer's dimensions
            if isinstance(v, dict) and "grid_search" in v:
                raise ValueError(
                    "AskTellSearcher does not combine with grid_search "
                    "markers — enumerate the grid as a Categorical or use "
                    "BasicVariantGenerator")
            if isinstance(v, Domain):
                # sample_from / custom domains resolve HERE — the
                # optimizer only sees concrete F/I/C dimensions
                fixed[k] = v.sample(self._rng)
            else:
                fixed[k] = v
        if self._is_optuna:
            handle = self._opt.ask(self._optuna_distributions())
            config = dict(fixed)
            config.update(handle.params)
        else:
            sampled = self._opt.ask({
                k: v for k, v in self.param_space.items()
                if isinstance(v, (Float, Integer, Categorical))})
            handle = None
            config = dict(fixed)
            config.update(sampled)
        self._live[trial_id] = (handle, dict(config))
        return config

    def on_trial_complete(self, trial_id: str,
                          result: Optional[dict] = None) -> None:
        entry = self._live.pop(trial_id, None)
        if entry is None or not result:
            return
        handle, config = entry
        v = result.get(self.metric) if self.metric else None
        if v is None:
            return
        if self._is_optuna:
            # optuna honours the study's own direction — pass raw
            self._opt.tell(handle, float(v))
        else:
            score = float(v) if self.mode == "max" else -float(v)
            self._opt.tell(config, score)
