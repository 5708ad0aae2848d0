"""Rule registry and repo-specific configuration for the graph-capture lint.

Every rule guards an invariant the port's byte accounting or its captured
cycles rest on; the rationale strings are why.  ``python -m
repro_torch.analysis --list-rules`` prints this table.  The rule ids are
the JAX package's (``repro/analysis/rules.py``) wherever the port has a
counterpart; :data:`NO_COUNTERPART` names the two that have none, and why.

Allowlisting
------------

A site that is genuinely fine appends a pragma comment::

    n = int(steps)              # graphlint: ok[host-sync] static config

``# graphlint: ok`` (no rule list) suppresses every rule on that line.  A
function whose body a CUDA graph captures but which the scanner cannot see
as one (it is captured from another module, and is not one of the
drivers' cycles in ``CAPTURED_ROOTS``) is marked on its ``def`` line::

    def step(x, state):         # graphlint: captured
        ...

Module-level allowlists (``COLLECTIVE_HOMES``) cover the places a raw
``torch.distributed`` call is supposed to live.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "CAPTURED_ROOTS",
    "CAPTURE_CONSUMERS",
    "COLLECTIVE_HOMES",
    "COLLECTIVE_MODULES",
    "COLLECTIVE_PRIMITIVES",
    "F64_DTYPE_NAMES",
    "HOST_CAST_BUILTINS",
    "HOST_SYNC_CALLS",
    "HOST_SYNC_METHODS",
    "NO_COUNTERPART",
    "NUMPY_MODULE_NAMES",
    "PEER_MODULES",
    "PEER_PRIMITIVES",
    "RULES",
    "Rule",
]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    rationale: str


RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            "host-sync",
            "No host read or Python branch on a tensor inside captured code",
            "A CUDA graph replays its kernels and nothing else: an "
            "`.item()`, `float()`, `.cpu()`, `.nonzero()` or an `if` on a "
            "tensor inside a captured cycle either fails the capture or, "
            "on the eager route, stalls the card once a step -- the "
            "round trip the device driver exists to remove (one host read "
            "a restart instead of one a step).",
        ),
        Rule(
            "f64-literal",
            "No hard-coded float64 inside captured cycle code",
            "The basis precision belongs to the StorageFormat and the "
            "arithmetic dtype; a stray torch.float64, .double() or "
            "dtype=torch.double inside the cycle widens a compressed "
            "basis row to 8 bytes a value and erases the FRSZ2 bandwidth "
            "win without failing any test.",
        ),
        Rule(
            "raw-collective",
            "torch.distributed calls only in their homes",
            "The wire model (exchange_bytes/gather_bytes/reduce_bytes) "
            "is complete only if every byte that crosses the fabric moves "
            "through repro_torch.dist.collectives (or the DTensor and "
            "group-setup plumbing); a direct all_reduce elsewhere is "
            "invisible to the census and to every wire figure.  The peer "
            "gather (kernels/peer_gather.py), the NVLink transport of "
            "MGS's second pass, is held alike, and a captured IF node's "
            "body may hold no other collective: CUDA refuses NCCL there.",
        ),
        # -- stage 2: audits of what runs ---------------------------------
        Rule(
            "retrace",
            "A second same-shape solve captures no new graph",
            "The graph cache keys on the identity of what the cycle reads; "
            "an unstable key (a per-solve tensor, a fresh partition) "
            "captures again on every solve, so the solve times the port "
            "reports become capture times and the cache grows by a basis "
            "store each call.",
        ),
        Rule(
            "f64-leak",
            "No f64 tensor made by an frsz2 cycle at f32 arithmetic",
            "Outside the least-squares state, which is f64 by design, an "
            "f64 tensor made inside the frsz2_16/f32 cycle is a basis or "
            "vector widened to full width: the results stay right and the "
            "bandwidth win silently goes.",
        ),
        Rule(
            "transfer",
            "A solve makes exactly the host reads and copies it documents",
            "The device driver reads the card once up front and three "
            "times a restart (HOST_TRAFFIC in solver/gmres.py); a read or "
            "a host-to-device copy more, inside a replay or around it, is "
            "a synchronization the driver-overhead figures do not show.",
        ),
        # -- stage 3: the recorded collective census ----------------------
        Rule(
            "nonuniform-collective",
            "Every rank issues the same collective sequence",
            "A group collective that one rank skips or issues with another "
            "shape hangs the whole group (every rank simply waits); an "
            "exchange whose send has no matching receive hangs its pair.  "
            "The census compares every rank's recorded sequence.",
        ),
        Rule(
            "bad-permutation",
            "Every exchange is a partial injection; rounds disjoint",
            "A duplicated source drops a message and a duplicated "
            "destination clobbers one; reusing a (src, dst) channel "
            "across the 3-D exchange's rounds serializes what the round "
            "packing exists to overlap.  NCCL and gloo accept all of it.",
        ),
        Rule(
            "axis-mismatch",
            "Every collective of a solve runs on the solve's group",
            "A collective on another group (the world where a subgroup "
            "solves, or the reverse) mixes ranks that are not in the "
            "solve; on one rank it passes, on a machine with more cards "
            "it hangs or sums the wrong chunks.",
        ),
        Rule(
            "wire-model",
            "Modelled wire bytes equal the recorded collectives' bytes",
            "exchange_bytes/gather_bytes/reduce_bytes and "
            "cycle_wire_bytes are hand-kept arithmetic; pricing every "
            "recorded operand (a reduction once, an all-gather (P - 1) "
            "times, a send once, coded buffers at codes plus exponents) "
            "and demanding exact equality makes the model a checked "
            "invariant.",
        ),
        Rule(
            "reads-model",
            "GmresResult.bytes_read/op_reads match a fixed trajectory",
            "bytes_read is the denominator of every bandwidth figure; on "
            "a pinned trajectory (target_rrn=0, CGS2, max_iters=k*m) it is "
            "exactly cycles x rows x row bytes, with the row bytes read "
            "off the real store tensors, so any drift between the "
            "accounting and the buffers is an error, not noise.",
        ),
    )
}

#: the JAX package's rules with no counterpart in the port, and why
NO_COUNTERPART: dict[str, str] = {
    "carry-drop": (
        "the port has no while_loop carry: a cycle's state is static "
        "buffers (the basis store, the f64 least-squares state) updated in "
        "place, so no branch can rebuild the carry without a field"),
    "spec-mismatch": (
        "the port has no partition specs: each rank holds its own chunk of "
        "every vector and of the basis, so there is no global state tree "
        "for a spec tree to mirror"),
}

#: functions whose bodies a CUDA graph captures, by path suffix and name
#: (module-level functions; ``tests/test_torch_analysis.py`` checks that
#: each still exists)
CAPTURED_ROOTS = (
    ("repro_torch/solver/gmres.py", "_device_cycle"),
    ("repro_torch/solver/block.py", "_block_cycle"),
)

#: callables (last dotted component) whose function-valued arguments are
#: captured: ``solver/gmres.py::_capture`` runs its argument under
#: ``torch.cuda.graph``
CAPTURE_CONSUMERS = frozenset({"_capture"})

#: builtins that read a tensor's value on the host
HOST_CAST_BUILTINS = frozenset({"float", "int", "bool", "complex"})

#: methods that read a tensor's value on the host (``.nonzero()``'s output
#: shape is the data's)
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero"})

#: calls (last dotted component) that wait for the card whatever their
#: arguments
HOST_SYNC_CALLS = frozenset({"synchronize"})

#: dtype spellings the f64-literal rule hunts for (``torch.float64``,
#: ``torch.double``, ``.double()``, ``"float64"``)
F64_DTYPE_NAMES = frozenset({"float64", "f64", "double"})

#: attribute roots treated as numpy (host) modules inside captured code
NUMPY_MODULE_NAMES = frozenset({"np", "numpy"})

#: path suffixes where raw torch.distributed calls (and the peer gather)
#: may live: the audited wrappers and the census that records them, the
#: peer gather's binding and plain version, group setup, and the DTensor
#: plumbing of the dry run (whose functional collectives the roofline
#: records itself)
COLLECTIVE_HOMES = (
    "repro_torch/dist/collectives.py",
    "repro_torch/dist/census.py",
    "repro_torch/kernels/peer_gather.py",
    "repro_torch/dist/launch.py",
    "repro_torch/dist/act_sharding.py",
    "repro_torch/launch/mesh.py",
    "repro_torch/roofline/analysis.py",
)

#: torch.distributed (and functional-collective) calls that move bytes
#: across the fabric.  Group queries (``get_rank``) and ``barrier`` are
#: deliberately absent: they ship no operand.
COLLECTIVE_PRIMITIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "gather_object", "scatter",
    "scatter_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "all_gather_tensor", "permute_tensor",
    "all_reduce_coalesced", "all_gather_into_tensor_coalesced",
    "reduce_scatter_tensor_coalesced",
})

#: module paths whose attributes are the primitives above
COLLECTIVE_MODULES = frozenset({
    "torch.distributed", "torch.distributed._functional_collectives",
    "torch.distributed.distributed_c10d",
})

#: the peer gather's module: its entry points move bytes across NVLink (the
#: transport of MGS's second-pass reductions inside an IF node), so they
#: are held to the homes above like the primitives of torch.distributed
PEER_MODULES = frozenset({"repro_torch.kernels.peer_gather"})
PEER_PRIMITIVES = frozenset({"reduce", "reduce_ref", "gather_ref"})
