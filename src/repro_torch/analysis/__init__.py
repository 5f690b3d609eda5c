"""tracelint for the port: static analysis of its torch / CUDA discipline.

The port's performance and correctness rest on hand-kept invariants --
one shape fingerprint per bucket for the counted solver entries, host
syncs kept out of what a CUDA graph captures, the float64 oracle
confined to ``kernels/ref.py``, shared memory sized to the H100's block
limit.  This package checks them at review time by walking the AST of
the port against a rule catalog with the JAX package's ids (one
``# tracelint: allow[CFN10x]`` pragma names one invariant in both):

  CFN101  host syncs (``.item()``, ``.tolist()``, ``.cpu()``,
          ``.numpy()``, casts of tensors, data-dependent shapes,
          boolean-mask indexing) inside CUDA-graph captures and
          ``torch.compile``d code, and in what they reach.
  CFN102  float64 outside the oracle whitelist.
  CFN103  pytree hygiene: flatten functions account for every field;
          ``degrade`` changes no shape.
  CFN104  the counted solver entries carry ``@count_traces`` with the
          JAX package's names.
  CFN105  shared memory: every launcher's ``*_launch_smem`` mirror fits
          the block at ``MAX_SCALE``; Triton loops over non-constexpr
          bounds.

Rules CFN106-CFN109 ride on the flow-sensitive, interprocedural dataflow
engine (``repro_torch.analysis.dataflow``):

  CFN106  random draws on the global stream; a generator re-seeded with
          a loop-invariant seed inside a loop.
  CFN107  an output buffer of a kernel launch that is also its input.
  CFN108  shape-cardinality: a static bound on the shape fingerprints of
          every ``@count_traces`` entry (``rules_flow.CACHE_CAPS``).
  CFN109  tensors computed and never read.

CLI: ``python -m repro_torch.analysis [--baseline FILE] [--format
text|json] [--changed [REF]] [paths...]`` (exit 1 on any non-suppressed
finding).  Suppression is per line via ``# tracelint: allow[CFN10x]``
pragmas or per finding via a committed baseline
(``analysis/baseline-torch.json`` for the port).  Only the standard
library is imported.
"""
from .engine import (Finding, Module, Project, ProjectRule, Rule,
                     analyze_paths, analyze_project, analyze_source,
                     apply_baseline, baseline_payload, iter_python_files,
                     load_baseline, load_project)
from .rules import (MAX_SCALE, SMEM_PER_BLOCK_BYTES, DtypeDiscipline,
                    PytreeHygiene, RetraceHazards, SharedMemoryBudget,
                    TraceCounterCoverage, all_rules)
from .rules_flow import (CACHE_CAPS, CacheCardinality, DeadDeviceCompute,
                         DonationDiscipline, EntryBound, PrngKeyDiscipline,
                         compute_cache_bounds, flow_rules)

__all__ = [
    "Finding", "Module", "Project", "ProjectRule", "Rule", "analyze_paths",
    "analyze_project", "analyze_source", "apply_baseline",
    "baseline_payload", "iter_python_files", "load_baseline", "load_project",
    "all_rules", "RetraceHazards", "DtypeDiscipline", "PytreeHygiene",
    "TraceCounterCoverage", "SharedMemoryBudget", "MAX_SCALE",
    "SMEM_PER_BLOCK_BYTES", "PrngKeyDiscipline", "DonationDiscipline",
    "CacheCardinality", "DeadDeviceCompute", "EntryBound", "CACHE_CAPS",
    "compute_cache_bounds", "flow_rules",
]
