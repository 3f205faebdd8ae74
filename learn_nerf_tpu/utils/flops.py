"""Roofline accounting for jitted programs (MFU / bandwidth utilization).

XLA's own cost analysis supplies the FLOP and device-memory byte counts of
a lowered program (exact for its HLO — no hand-counted model math to drift
out of sync); :func:`jaxpr_matmul_flops` counts matmul FLOPs from the
traced shapes alone.  Peaks come from :data:`PEAKS`, one entry per
``device_kind``; a device missing from the table is an error, never a
default.

``roofline(cost, seconds, device_kind, precision)`` reports achieved
FLOP/s, MFU, achieved bytes/s, bandwidth utilization, and which resource
the roofline says binds.
"""

from typing import Dict, Optional

#: Published peaks per ``jax.Device.device_kind``: dense matmul FLOP/s by
#: operand precision (no sparsity) and device-memory bytes/s.  Source:
#: NVIDIA H100 Tensor Core GPU data sheet, SXM part, at its 700 W limit.
#: A float32 matmul at XLA's default precision may run as TF32 on this
#: card; under ``jax.default_matmul_precision("highest")`` it runs at the
#: ``fp32`` rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        bf16=989e12, tf32=495e12, fp32=67e12, bytes_per_sec=3.35e12
    ),
}


def device_peaks(device_kind: str) -> Dict[str, float]:
    """The :data:`PEAKS` entry of ``device_kind``; raises for others."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add it to "
            f"learn_nerf_tpu.utils.flops.PEAKS with its source"
        ) from None


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _dot_general_flops(eqn) -> float:
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    lhs = eqn.invars[0].aval.shape
    rhs = eqn.invars[1].aval.shape
    batch = _prod(lhs[i] for i in lb)
    k = _prod(lhs[i] for i in lc)
    m = _prod(lhs[i] for i in range(len(lhs)) if i not in set(lc) | set(lb))
    n = _prod(rhs[i] for i in range(len(rhs)) if i not in set(rc) | set(rb))
    return 2.0 * batch * m * n * k


def jaxpr_matmul_flops(jaxpr) -> float:
    """Analytic matmul FLOPs of a (Closed)Jaxpr — MFU's conventional
    numerator, counted from shapes without any backend at all.

    Walks the traced jaxpr: 2*M*N*K per ``dot_general`` (batch dims
    multiplied in), recursing into every sub-jaxpr. ``scan`` bodies are
    multiplied by their trip count; ``while`` bodies are counted ONCE
    (trip count is data-dependent — none of our hot steps use one);
    ``cond`` takes the most expensive branch. Elementwise/gather work is
    deliberately excluded: MFU is defined on matrix-unit FLOPs.
    """
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)  # accept ClosedJaxpr
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += _dot_general_flops(eqn)
            continue
        subs = []
        for val in eqn.params.values():
            if hasattr(val, "eqns") or hasattr(val, "jaxpr"):
                subs.append(val)
            elif isinstance(val, (tuple, list)):
                subs.extend(v for v in val
                            if hasattr(v, "eqns") or hasattr(v, "jaxpr"))
        if not subs:
            continue
        if prim == "cond":
            total += max(jaxpr_matmul_flops(s) for s in subs)
        else:
            mult = eqn.params.get("length", 1) if prim == "scan" else 1
            total += mult * sum(jaxpr_matmul_flops(s) for s in subs)
    return total


def traced_flops(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Trace ``fn`` (host-only, seconds) and return analytic matmul FLOPs
    as a ``lowered_cost``-shaped dict with no byte count (``bytes`` is a
    layout/fusion property only the compiler knows)."""
    import jax

    try:
        closed = jax.make_jaxpr(fn, **kwargs)(*args)
    except Exception:
        return None
    flops = jaxpr_matmul_flops(closed)
    if flops <= 0.0:
        return None
    return dict(flops=flops, bytes=None, source="jaxpr-matmul")


def lowered_cost(lowered) -> Optional[Dict[str, float]]:
    """FLOPs / bytes-accessed of an already-``lower()``-ed jit program per
    XLA's HLO cost analysis (``None`` when it reports no FLOPs; callers
    then fall back to :func:`traced_flops` rather than guess)."""
    analysis = lowered.cost_analysis()
    if isinstance(analysis, (list, tuple)):  # per-device wrapping
        analysis = analysis[0]
    if not analysis:
        return None
    flops = float(analysis.get("flops", 0.0))
    if flops <= 0.0:
        return None
    return dict(flops=flops, bytes=float(analysis.get("bytes accessed", 0.0)))


def roofline(
    cost: Optional[Dict[str, float]],
    seconds: float,
    device_kind: str,
    precision: str = "tf32",
) -> Dict[str, float]:
    """Achieved rates vs the peaks of ``device_kind`` for one program
    execution; ``precision`` (``bf16``/``tf32``/``fp32``) picks the matmul
    peak the MFU divides by."""
    peaks = device_peaks(device_kind)
    if cost is None or seconds <= 0:
        return {}
    peak_flops = peaks[precision]
    peak_bytes = peaks["bytes_per_sec"]
    achieved_flops = cost["flops"] / seconds
    if cost.get("bytes") is None:
        # Analytic (jaxpr-walk) source: matmul FLOPs are exact but bytes
        # are a compiler/layout property — report the matmul side only.
        return dict(
            tflops=round(achieved_flops / 1e12, 2),
            mfu=round(achieved_flops / peak_flops, 4),
            flops_source=cost.get("source", "jaxpr-matmul"),
        )
    achieved_bytes = cost["bytes"] / seconds
    compute_time = cost["flops"] / peak_flops
    memory_time = cost["bytes"] / peak_bytes
    bound = "compute" if compute_time >= memory_time else "memory"
    # Utilization against whichever resource the roofline says binds:
    # the fraction of speed-of-light this program achieved.
    sol = max(compute_time, memory_time) / seconds
    return dict(
        tflops=round(achieved_flops / 1e12, 2),
        mfu=round(achieved_flops / peak_flops, 4),
        gbps=round(achieved_bytes / 1e9, 1),
        bw_util=round(achieved_bytes / peak_bytes, 4),
        bound=bound,
        speed_of_light_frac=round(sol, 4),
    )
