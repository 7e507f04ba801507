"""EXPLAIN ANALYZE (DESIGN.md §19): join the optimizer's estimates with
what the query actually did.

`QueryHandle.report()` calls `build_report(handle)` after the query
completes. The estimated side is `Session._explain()` — per-stage
selectivity and mean cost from the sampling investment (re-read at report
time, i.e. with this query's own sampling folded in, which is exactly
what its per-document plans were built from). The actual side is pulled
from three places the run already maintains:

  * per-attr token/call columns on the query's child ledger
    (`CostLedger.per_attr` / `per_attr_calls`, charged at the scheduler's
    extraction sites);
  * per-filter evaluation counts on the `QueryRun`
    (`filter_evals[(table, filter)] = [evaluated, passed]`, bumped in
    `_eval_plan_co` where the short-circuit actually decided);
  * the ledger's savings columns (prefix/spec/cascade) and, when a tracer
    is attached, per-kind wall attribution from the span stream.

This closes the loop the paper's cost model needs: estimated vs. actual
selectivity per stage is the direct residual of the sample statistics,
and tokens-per-invocation vs. `mean_cost_tokens` is the residual of the
cost model.
"""
from __future__ import annotations


def _stage_actuals(run, ledger, table: str, stage: dict) -> dict:
    attr = stage["attr"]
    evals = run.filter_evals.get((table, stage["filter"]))
    evaluated, passed = evals if evals else (0, 0)
    tokens = ledger.per_attr.get(attr, 0)
    calls = ledger.per_attr_calls.get(attr, 0)
    return {
        "filter": stage["filter"],
        "attr": attr,
        "est_selectivity": stage["selectivity"],
        "actual_selectivity": (round(passed / evaluated, 4)
                               if evaluated else None),
        "evaluated": evaluated,
        "passed": passed,
        "est_cost_tokens": stage["mean_cost_tokens"],
        "actual_tokens": tokens,
        "invocations": calls,
        "actual_tokens_per_call": (round(tokens / calls, 2)
                                   if calls else None),
        "predicted_tier_split": stage.get("predicted_tier_split"),
    }


def build_report(handle) -> dict:
    """Estimated-vs-actual post-query report for a finished QueryHandle."""
    if not handle.done:
        raise RuntimeError(
            f"query {handle.qid} still in flight — report() joins "
            f"estimates with actuals, so it needs the query finished")
    session = handle.session
    ledger = handle.ledger
    plan = session._explain(handle.query)
    run = handle.run
    snap = ledger.snapshot()
    tables = []
    for t in plan["tables"]:
        entry = {
            "table": t["table"],
            "candidate_docs": t["candidate_docs"],
            "sampling": {
                "estimated": t["sampling"],
                "reused": run.sampling_reused.get(t["table"]),
            },
            "stages": [_stage_actuals(run, ledger, t["table"], st)
                       for st in t.get("stages", [])],
        }
        if "est_total_cost_tokens" in t:
            entry["est_total_cost_tokens"] = t["est_total_cost_tokens"]
            entry["est_pass_rate"] = t["est_pass_rate"]
        tables.append(entry)
    report = {
        "qid": handle.qid,
        "query": plan["query"],
        "tenant": handle.tenant,
        "rows": len(handle._rows),
        "wall_s": round(ledger.wall_time_s, 6),
        "tables": tables,
        "totals": {
            "input_tokens": snap["input_tokens"],
            "output_tokens": snap["output_tokens"],
            "llm_calls": snap["llm_calls"],
            "extractions": snap["extractions"],
            "per_phase": snap["per_phase"],
        },
        "savings": {
            "prefix_hits": snap["prefix_hits"],
            "saved_prefill_tokens": snap["saved_prefill_tokens"],
            "draft_tokens": snap["draft_tokens"],
            "accepted_tokens": snap["accepted_tokens"],
            "decode_steps_saved": snap["decode_steps_saved"],
            "cascade_small": snap["cascade_small"],
            "cascade_escalations": snap["cascade_escalations"],
            "target_tokens_saved": snap["target_tokens_saved"],
        },
    }
    tracer = getattr(session, "tracer", None)
    if tracer is not None and tracer.spans:
        report["trace"] = {"clock": tracer.clock_kind,
                           "spans": len(tracer.spans),
                           "by_kind": tracer.by_kind()}
    return report


def _fmt(v, nd=4):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def render_report(report: dict) -> str:
    """Human-readable EXPLAIN ANALYZE table (examples/explain_analyze.py)."""
    lines = [f"EXPLAIN ANALYZE  query {report['qid']}: {report['query']}",
             f"  rows={report['rows']} wall={report['wall_s']:.3f}s "
             f"tokens={report['totals']['input_tokens']}+"
             f"{report['totals']['output_tokens']} "
             f"calls={report['totals']['llm_calls']}"]
    hdr = (f"    {'stage':<34} {'est_sel':>8} {'act_sel':>8} "
           f"{'est_tok':>8} {'act_tok/call':>12} {'calls':>6}")
    for t in report["tables"]:
        samp = t["sampling"]
        est = samp["estimated"]
        est_txt = (f"reused ({est.get('n_sampled', '?')} docs)"
                   if est.get("reused")
                   else f"planned ~{est.get('planned_sample', '?')} docs")
        act_txt = ("reused" if samp["reused"] else
                   "paid" if samp["reused"] is not None else "-")
        lines.append(f"  TABLE {t['table']}: {t['candidate_docs']} candidates"
                     f" | sampling est: {est_txt} | actual: {act_txt}")
        if t["stages"]:
            lines.append(hdr)
        for st in t["stages"]:
            name = st["filter"]
            if len(name) > 34:
                name = name[:31] + "..."
            lines.append(
                f"    {name:<34} {_fmt(st['est_selectivity']):>8} "
                f"{_fmt(st['actual_selectivity']):>8} "
                f"{_fmt(st['est_cost_tokens']):>8} "
                f"{_fmt(st['actual_tokens_per_call']):>12} "
                f"{st['invocations']:>6}")
        if "est_total_cost_tokens" in t:
            lines.append(f"    => est total ~{t['est_total_cost_tokens']} "
                         f"tokens, est pass rate {t['est_pass_rate']}")
    sav = report["savings"]
    parts = []
    if sav["prefix_hits"]:
        parts.append(f"prefix: {sav['prefix_hits']} hits / "
                     f"{sav['saved_prefill_tokens']} tok saved")
    if sav["draft_tokens"]:
        parts.append(f"spec: {sav['accepted_tokens']}/{sav['draft_tokens']} "
                     f"accepted, {sav['decode_steps_saved']} steps saved")
    if sav["cascade_small"] or sav["cascade_escalations"]:
        parts.append(f"cascade: {sav['cascade_small']} small / "
                     f"{sav['cascade_escalations']} escalated / "
                     f"{sav['target_tokens_saved']} tok saved")
    lines.append("  savings: " + ("; ".join(parts) if parts else "none"))
    tr = report.get("trace")
    if tr:
        kinds = ", ".join(f"{k}={v['spans']}"
                          for k, v in sorted(tr["by_kind"].items()))
        lines.append(f"  trace: {tr['spans']} spans ({tr['clock']} clock): "
                     f"{kinds}")
    return "\n".join(lines)
