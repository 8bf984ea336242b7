"""Domain registry: the repo-specific knowledge the rules consult.

Everything subjective about the analysis lives HERE, in one reviewable
place — unit vocabularies, per-rule path allowlists (each with its
rationale), and the intentionally-unvalidated config registry — so a
rule module only encodes mechanics, never policy.

Every entry equals the JAX package's registry, entry for entry: the two
linters both scan `src/`, and a tree one of them passes must pass the
other (`tests/test_torch_lint.py` compares the data).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# units vocabulary
# ---------------------------------------------------------------------------

#: name-suffix -> unit tag.  ``bandwidth_gbps`` tags Gb/s; ``wall_s``
#: tags seconds; ``*_bw`` is the repo's bytes/s-rate suffix
#: (wireless_bw, cut_bw, chiplet_noc_bw ...).  The table is the
#: naming convention the README documents.
SUFFIX_UNITS = {
    "gbps": "gbps",
    "bw": "bytes_per_s",
    "bytes": "bytes",
    "bits": "bits",
    "pj": "pj",
    "j": "joules",
    "s": "seconds",
    "ms": "milliseconds",
    "us": "microseconds",
    "ns": "nanoseconds",
    "hops": "hops",
    "mm": "mm",
    "ghz": "ghz",
}

#: exact names whose unit carries no suffix (legacy/paper spellings).
NAME_UNITS = {
    "bandwidth": "bytes_per_s",       # NetworkConfig/WirelessConfig field
    "nbytes": "bytes",                # TrafficTrace per-message sizes
    "byte_links": "bytes",            # engine energy: bytes x traversed links
    "bits": "bits",
    "wall": "seconds",
}

#: conversion helpers (repro_torch.units) -> the unit tag of their
#: RESULT.
#: Routing a mixed-unit expression through one of these is what makes
#: the mix explicit — and silences `units-call-mix`.
HELPER_RESULT_UNITS = {
    "gbps_to_bytes_per_s": "bytes_per_s",
    "bytes_per_s_to_gbps": "gbps",
    "bytes_to_bits": "bits",
    "pj_to_j": "joules",
    "s_to_ms": "milliseconds",
    "s_to_us": "microseconds",
}

#: scale-factor literals that may only appear as named constants from
#: `repro_torch.units` when multiplied/divided into a quantity.
MAGIC_SCALE_LITERALS = {
    1e3, 1e6, 1e9, 1e12, 1e-12,
    8e9, 16e9, 32e9, 64e9, 96e9,     # the paper's Gb/s points, pre-folded
}

#: unit tags for which a bare ``* 8`` / ``/ 8`` is a bit<->byte
#: conversion (use BITS_PER_BYTE / the helpers).
BYTEISH_UNITS = {"bytes", "bits", "bytes_per_s", "gbps"}

#: files exempt from the units family: the constants module IS the
#: conversion layer.
UNITS_EXEMPT_SUFFIXES = ("repro/units.py", "repro/core/units.py")

# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

#: wall-clock reads allowed only here.  Rationale per entry:
#: - obs/metrics.py: `MetricsRegistry.span` is the ONE sanctioned
#:   wall-timer; every other module times through it.
#: - obs/profile.py: the phase profiler — measuring the framework's
#:   own wall time is its purpose; every other module profiles through
#:   `profile.phase` / `MetricsRegistry.span`, never a raw clock.
#: - launch/: command-line entry points that measure real executions
#:   (JAX's in the reference, torch's on the card in the port) — wall
#:   clock is the measurement, as in benchmarks/.
#: - benchmarks/: regression timings are wall-clock by definition.
WALLCLOCK_ALLOWED_SUFFIXES = ("obs/metrics.py", "obs/profile.py")
WALLCLOCK_ALLOWED_SEGMENTS = ("launch", "benchmarks")

#: module-level numpy legacy RNG functions (seed-global state).
NP_RANDOM_LEGACY = {
    "seed", "random", "rand", "randn", "randint", "random_sample",
    "ranf", "sample", "choice", "shuffle", "permutation", "normal",
    "uniform", "standard_normal", "poisson", "beta", "binomial",
    "exponential", "gamma", "geometric", "bytes",
}

#: stdlib ``random`` module functions drawing from the global stream.
STDLIB_RANDOM_FNS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "seed", "getrandbits", "triangular", "expovariate",
}

# ---------------------------------------------------------------------------
# trace / obs hygiene
# ---------------------------------------------------------------------------

#: the only modules allowed to call ``print`` directly:
#: - obs/metrics.py: `MetricsLogger` is the repo's one output funnel.
#: - lint/cli.py: the analyzer's own CLI — stdout is its interface.
PRINT_ALLOWED_SUFFIXES = ("obs/metrics.py", "lint/cli.py")

# ---------------------------------------------------------------------------
# config hygiene
# ---------------------------------------------------------------------------

#: public config-like dataclasses (``*Config`` / ``*Spec`` / ``*Plan``)
#: registered as intentionally unvalidated, with the reason.  Anything
#: config-like and public NOT listed here must validate in
#: ``__post_init__``.
UNVALIDATED_CONFIGS = {
    # model-plane configs: shapes are checked when the weights are
    # first built (jax.eval_shape in the reference, the port's init on
    # torch); numeric fields have no domain beyond "positive", and the
    # dryrun harness exercises every zoo entry.
    "BlockSpec": "model-plane; shape-checked by jax at init",
    "ShapeConfig": "derived serving shapes; checked by make_serve_fns",
    "ServeConfig": "serving knobs; exercised by launch/serve drivers",
    "TrainConfig": "training knobs; exercised by launch/train drivers",
    "DataConfig": "pipeline knobs; any seed/int is valid",
    "OptimizerConfig": "optimizer knobs; validated by build_optimizer",
    "CompressionConfig": "codec knobs; validated at compress time",
    # runtime plane
    "ElasticPlan": "constructed only by ElasticPlan.plan, which validates",
    # arch plane
    "ChipletSpec": "catalog rows are literals audited in arch/catalog.py",
    "PlaneConfig": "hybrid-schedule internal; built from validated nets",
    # lint's own fixtures/config dataclasses would be false positives
    # if the analyzer is ever pointed at itself recursively; none today.
}

#: dataclass field names that stamp run metadata and must never affect
#: equality: declared with ``dataclasses.field(..., compare=False)``.
PROVENANCE_FIELD_NAMES = {"provenance"}
