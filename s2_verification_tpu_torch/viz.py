"""HTML visualization of a history and its (partial) linearization.

The equivalent of ``porcupine.Visualize`` as used by the reference checker
(golang/s2-porcupine/main.go:608-631): a self-contained interactive HTML
timeline, one horizontal lane per client, one bar per operation spanning its
call→return window in real time, annotated with the linearization order when
the check succeeded (or the deepest linearized prefix found when it failed).

No external assets: styles and the tooltip script are inlined so the file
renders offline, matching the reference's single-artifact behavior.

The port's copy of the JAX package's ``viz.py``, byte for byte the same
HTML for the same history and result (``tests/test_torch_viz.py``).  Of
its panels below the timeline it keeps all three: the frontier timeline,
the mesh shard panel (a sharded search's ``stats.shards``) and the
supervised-child panel (the span ring a supervised child ships home,
drawn in the daemon's artifacts).
"""

from __future__ import annotations

import html
import json

from .checker.entries import History, Op
from .checker.oracle import CheckOutcome, CheckResult
from .models.stream import describe_operation, describe_state

__all__ = ["render_html", "write_visualization"]


_CSS = """
body { font: 13px/1.45 -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 24px; color: #1a1d21; background: #fff; }
h1 { font-size: 17px; margin: 0 0 2px; }
.meta { color: #5f6672; margin-bottom: 14px; }
.verdict { display: inline-block; padding: 2px 10px; border-radius: 10px;
           font-weight: 600; }
.verdict.ok { background: #e3f4e6; color: #176936; }
.verdict.illegal { background: #fdebec; color: #a12622; }
.verdict.unknown { background: #fff3dc; color: #8a6100; }
.lane { display: flex; align-items: center; margin: 3px 0; }
.lane-label { width: 84px; flex: none; text-align: right; padding-right: 10px;
              color: #5f6672; font-variant-numeric: tabular-nums; }
.lane-track { position: relative; flex: 1; height: 26px;
              background: #f4f5f7; border-radius: 4px; }
.op { position: absolute; top: 3px; height: 20px; border-radius: 3px;
      min-width: 7px; box-sizing: border-box; cursor: default;
      border: 1px solid rgba(0,0,0,.25); }
.op.success { background: #9fd7ab; }
.op.definite { background: #f3a6a3; }
.op.indef { background: #ffd488; border-style: dashed; }
.op.pending { background: #ffd488; border-style: dashed; opacity: .75; }
.op .ord { position: absolute; top: -1px; left: 2px; font-size: 10px;
           font-weight: 700; color: #19306b; }
.op.linearized { outline: 2px solid #4164c9; }
.op.refused { outline: 2px dashed #a12622; }
.legend { margin: 14px 0 0; color: #5f6672; }
.legend span.chip { display: inline-block; width: 12px; height: 12px;
                    border-radius: 3px; margin: 0 4px 0 12px;
                    vertical-align: -2px; border: 1px solid rgba(0,0,0,.25); }
#tip { position: fixed; display: none; max-width: 560px; z-index: 10;
       background: #1a1d21; color: #f4f5f7; padding: 7px 10px;
       border-radius: 5px; font-size: 12px; white-space: pre-wrap;
       pointer-events: none; }
.final { margin-top: 14px; }
code { background: #f4f5f7; padding: 1px 4px; border-radius: 3px; }
.frontier { margin-top: 18px; }
.frontier h2 { font-size: 14px; margin: 0 0 6px; }
.flayer { display: flex; align-items: center; margin: 1px 0; }
.flayer-label { width: 84px; flex: none; text-align: right; padding-right: 10px;
                color: #5f6672; font-size: 11px;
                font-variant-numeric: tabular-nums; }
.flayer-track { position: relative; flex: 1; height: 14px;
                background: #f4f5f7; border-radius: 3px; }
.fbar { position: absolute; top: 1px; left: 0; height: 12px; min-width: 2px;
        border-radius: 2px; background: #7ea6e0; cursor: default;
        border: 1px solid rgba(0,0,0,.2); }
.fbar.spill { background: #c9a0dc; }
.fbar.closed { background: #e0b97e; }
.fnote { color: #5f6672; font-size: 11px; margin-top: 4px; }
"""

_JS = """
const tip = document.getElementById('tip');
document.querySelectorAll('.op, .fbar').forEach(el => {
  el.addEventListener('mousemove', e => {
    tip.textContent = el.dataset.tip;
    tip.style.display = 'block';
    tip.style.left = Math.min(e.clientX + 14, innerWidth - 580) + 'px';
    tip.style.top = (e.clientY + 14) + 'px';
  });
  el.addEventListener('mouseleave', () => tip.style.display = 'none');
});
const cfgData = document.getElementById('cfg-data');
if (cfgData) {
  const cfgs = JSON.parse(cfgData.textContent);
  const byOpid = {};
  document.querySelectorAll('.op[data-opid]').forEach(el => {
    byOpid[el.dataset.opid] = el;
  });
  const apply = i => {
    const cfg = cfgs[i];
    for (const [opid, el] of Object.entries(byOpid)) {
      el.classList.remove('linearized', 'refused');
      const ord = el.querySelector('.ord');
      if (ord) ord.remove();
      el.dataset.tip = el.dataset.basetip;
      if (opid in cfg.ord) {
        el.classList.add('linearized');
        const s = document.createElement('span');
        s.className = 'ord';
        s.textContent = cfg.ord[opid];
        el.appendChild(s);
        el.dataset.tip += '\\nlinearized at position ' + cfg.ord[opid] +
          ' (configuration ' + (+i + 1) + ')';
      }
      if (cfg.refused.includes(+opid)) {
        el.classList.add('refused');
        el.dataset.tip += '\\nREFUSED to linearize at this configuration';
      }
    }
    document.querySelectorAll('.client-summary').forEach(el => {
      el.textContent = cfg.clients[el.dataset.client] || '';
    });
  };
  const sel = document.getElementById('cfg-select');
  if (sel) sel.addEventListener('change', () => apply(sel.value));
  apply(0);
}
"""


def _is_valid_order(history: History, seq: list[int]) -> bool:
    """Whether ``seq`` is a valid linearization order of its own op set:
    every step legal from the states it reaches, and no op placed after
    one whose return precedes its call.  O(n · states) — the cheap check
    that lets an already-ordered refusals prefix skip the DFS re-derive."""
    from .models.stream import INIT_STATE, step_set

    states = [INIT_STATE]
    for j in seq:
        op = history.ops[j]
        states = step_set(states, op.inp, op.out)
        if not states:
            return False
    # Real-time windows: a violation exists iff at some split point an
    # earlier op's call exceeds a later op's return (a.ret < b.call with b
    # before a) — prefix-max(call) vs suffix-min(ret), O(n).
    n = len(seq)
    suffix_min_ret = [0] * (n + 1)
    suffix_min_ret[n] = 1 << 62
    for i in range(n - 1, -1, -1):
        op = history.ops[seq[i]]
        ret = (1 << 62) if op.pending else op.ret
        suffix_min_ret[i] = min(suffix_min_ret[i + 1], ret)
    max_call = -1
    for i in range(n):
        max_call = max(max_call, history.ops[seq[i]].call)
        if suffix_min_ret[i + 1] < max_call:
            return False
    return True


def _frontier_panel(result: CheckResult) -> str:
    """Frontier-timeline panel: one row per BFS layer, bar width scaled
    (log) by frontier size against the widest layer, from the per-layer
    ``FrontierStats.timeline`` that ``profile=`` collection attaches.
    Returns "" when the result carries no timeline."""
    import math

    st = getattr(result, "stats", None)
    timeline = getattr(st, "timeline", None) if st is not None else None
    if not timeline:
        return ""
    peak = max(int(e.get("frontier") or 0) for e in timeline) or 1
    rows = []
    for e in timeline:
        fr = int(e.get("frontier") or 0)
        width = (
            100.0 * math.log1p(fr) / math.log1p(peak) if peak > 1 else 100.0
        )
        classes = ["fbar"]
        if e.get("spill"):
            classes.append("spill")
        elif e.get("auto_closed"):
            classes.append("closed")
        tip_parts = [
            f"layer {e.get('layer')}",
            f"frontier width: {fr}",
            f"state-set size: {e.get('states')}",
            f"auto-closed here: {e.get('auto_closed')}",
            f"elapsed: {e.get('elapsed_s')}s",
        ]
        if "stop" in e:
            seg = f"segment stop: {e['stop']}"
            if "bucket" in e:
                seg += f" (bucket {e['bucket']})"
            tip_parts.append(seg)
        if e.get("spill"):
            tip_parts.append("out-of-core spill layer")
        tip = html.escape("\n".join(tip_parts), quote=True).replace(
            "\n", "&#10;"
        )
        rows.append(
            f'<div class="flayer">'
            f'<div class="flayer-label">L{e.get("layer")} · {fr}</div>'
            f'<div class="flayer-track">'
            f'<div class="{" ".join(classes)}" style="width:{width:.2f}%" '
            f'data-tip="{tip}"></div></div></div>'
        )
    note = (
        f"{st.layers} layers, max frontier {st.max_frontier}, "
        f"max state set {st.max_state_set}, expanded {st.expanded}, "
        f"auto-closed {st.auto_closed}, pruned {st.pruned}"
    )
    return (
        '<div class="frontier"><h2>frontier timeline</h2>'
        + "".join(rows)
        + f'<div class="fnote">{html.escape(note)} &mdash; bar width is '
        f"log-scaled frontier size; purple = out-of-core spill layer, "
        f"amber = auto-closes fired</div></div>"
    )


def _shard_panel(result: CheckResult) -> str:
    """Mesh-shard panel: one row per device shard of a sharded search,
    bar width scaled by peak live occupancy against the busiest shard
    (from ``FrontierStats.shards``).  Returns "" for unsharded runs."""
    st = getattr(result, "stats", None)
    shards = getattr(st, "shards", None) if st is not None else None
    if not shards:
        return ""
    peak = max(int(s.get("peak_occupancy") or 0) for s in shards) or 1
    rows = []
    for s in shards:
        occ = int(s.get("peak_occupancy") or 0)
        width = 100.0 * occ / peak
        segs = max(int(s.get("segments") or 0), 1)
        skew = float(s.get("skew") or 1.0)
        classes = ["fbar"]
        if skew > 1.25:
            classes.append("closed")  # amber: shard running hot vs mean
        tip_parts = [
            f"shard {s.get('shard')} — {s.get('device')}",
            f"peak live rows: {occ}",
            f"mean live rows: {(s.get('occupancy_sum') or 0) / segs:.1f}",
            f"segments: {s.get('segments')}",
            f"collective wall: {s.get('collective_wall_s')}s",
            f"skew vs mesh mean: {skew}",
        ]
        tip = html.escape("\n".join(tip_parts), quote=True).replace(
            "\n", "&#10;"
        )
        rows.append(
            f'<div class="flayer">'
            f'<div class="flayer-label">S{s.get("shard")} · {occ}</div>'
            f'<div class="flayer-track">'
            f'<div class="{" ".join(classes)}" style="width:{width:.2f}%" '
            f'data-tip="{tip}"></div></div></div>'
        )
    coll = max(float(s.get("collective_wall_s") or 0.0) for s in shards)
    note = (
        f"{len(shards)} shards, peak occupancy {peak}, "
        f"max skew {max(float(s.get('skew') or 1.0) for s in shards)}, "
        f"collective wall {coll}s"
    )
    return (
        '<div class="frontier"><h2>mesh shards</h2>'
        + "".join(rows)
        + f'<div class="fnote">{html.escape(note)} &mdash; bar width is '
        f"peak live frontier rows per shard; amber = shard &gt;1.25&times; "
        f"the mesh mean (skew)</div></div>"
    )


def _child_panel(result: CheckResult) -> str:
    """Supervised-child panel: one row per span of the escalation child's
    own trace ring (``result.child_trace``, shipped home in the result
    JSON), bar offset/width scaled against the child's busy window.
    Returns "" when the verdict did not come from a supervised child."""
    ct = getattr(result, "child_trace", None)
    spans = ct.get("spans") if isinstance(ct, dict) else None
    spans = [s for s in spans or [] if s.get("ph") == "X"]
    if not spans:
        return ""
    lo = min(float(s["ts"]) for s in spans)
    hi = max(float(s["ts"]) + float(s.get("dur") or 0.0) for s in spans)
    total = max(hi - lo, 1.0)
    rows = []
    for s in sorted(spans, key=lambda s: float(s["ts"])):
        ts = float(s["ts"]) - lo
        dur = float(s.get("dur") or 0.0)
        left = 100.0 * ts / total
        width = max(100.0 * dur / total, 0.5)
        tip_parts = [
            f"{s.get('name')}",
            f"start: {ts / 1e6:.3f}s into child",
            f"duration: {dur / 1e6:.3f}s",
        ]
        devices = (s.get("args") or {}).get("devices")
        if devices:
            tip_parts.append(f"devices: {devices}")
        tip = html.escape("\n".join(tip_parts), quote=True).replace(
            "\n", "&#10;"
        )
        rows.append(
            f'<div class="flayer">'
            f'<div class="flayer-label">{html.escape(str(s.get("name")))}</div>'
            f'<div class="flayer-track">'
            f'<div class="fbar" style="margin-left:{left:.2f}%;'
            f'width:{width:.2f}%" data-tip="{tip}"></div></div></div>'
        )
    note = (
        f"child pid {ct.get('pid')}, trace {ct.get('trace_id') or '-'}, "
        f"{len(spans)} span(s), busy window {total / 1e6:.3f}s"
    )
    if ct.get("dropped"):
        note += f" — {ct['dropped']} span(s) dropped (ring saturated)"
    return (
        '<div class="frontier"><h2>supervised child</h2>'
        + "".join(rows)
        + f'<div class="fnote">{html.escape(note)} &mdash; bars are the '
        f"child process's own spans, offset within its busy window</div>"
        "</div>"
    )


def _op_class(op: Op) -> str:
    if op.pending:
        return "pending"
    if not op.out.failure:
        return "success"
    if op.out.definite_failure:
        return "definite"
    return "indef"


def render_html(
    history: History,
    result: CheckResult,
    *,
    title: str = "s2 linearizability check",
    checked: History | None = None,
) -> str:
    """Render the timeline.  ``history`` is the full prepared history shown
    in the lanes; ``checked`` is the (possibly trivial-op-elided) history the
    result's op indices refer to — linearization annotations are joined back
    onto the full history by wire ``op_id``."""
    checked = checked if checked is not None else history
    order_by_opid: dict[int, int] = {}
    if result.linearization is not None:
        for pos, idx in enumerate(result.linearization):
            order_by_opid[checked.ops[idx].op_id] = pos + 1
    deepest_opids = {checked.ops[i].op_id for i in (result.deepest or [])}
    # Ops that refused to linearize at the deepest configuration(s) — the
    # culprits of a failed check (porcupine info analog, main.go:606,627).
    refused_opids = {
        checked.ops[i].op_id
        for _, refused in (result.refusals or [])
        for i in refused
    }
    # Per-configuration exploration data for failed/inconclusive checks:
    # each deepest configuration gets one concrete linearization ORDER
    # (re-derived; diagnostics.derive_path), its refusing ops, and a
    # per-client breakdown — the explorable partial-linearization info
    # porcupine's artifact exposes per client (main.go:606,627).
    cfgs: list[dict] = []
    if result.outcome in (CheckOutcome.ILLEGAL, CheckOutcome.UNKNOWN):
        from .checker.diagnostics import derive_path

        n_checked = len(checked.ops)
        # Per-client op totals are configuration-independent: build once.
        totals: dict[int, int] = {}
        for op in checked.ops:
            totals[op.client_id] = totals.get(op.client_id, 0) + 1
        for prefix, refused in result.refusals or []:
            # The prefix may already BE a valid order (diagnostics-derived
            # refusals store one); re-deriving would repeat a 200k-node DFS
            # per configuration.  Device-produced configs store sorted sets
            # — those (and only those) go through derive_path.
            if _is_valid_order(checked, list(prefix)):
                order = list(prefix)
            else:
                order, _state = derive_path(checked, list(prefix))
            if order is None:
                # Not re-derivable (budget): an empty ord map would make
                # the selector STRIP the static outlines without replacing
                # them — drop this configuration from the explorable view
                # instead (the static deepest/refused annotations and the
                # textual report above still cover it).
                continue
            ordmap = {
                checked.ops[i].op_id: pos + 1
                for pos, i in enumerate(order)
            }
            refused_ids = sorted(checked.ops[i].op_id for i in refused)
            clients: dict[str, str] = {}
            by_client_n: dict[int, int] = {}
            for i in prefix:
                cl = checked.ops[i].client_id
                by_client_n[cl] = by_client_n.get(cl, 0) + 1
            by_client_r: dict[int, list[int]] = {}
            for i in refused:
                op = checked.ops[i]
                by_client_r.setdefault(op.client_id, []).append(op.op_id)
            # EVERY client appears — "0/n ops linearized" is information
            # (that client's whole lane is stuck behind the refusal).
            for cl in sorted(totals):
                txt = f"{by_client_n.get(cl, 0)}/{totals[cl]} ops linearized"
                if cl in by_client_r:
                    ids = ", ".join(str(x) for x in sorted(by_client_r[cl]))
                    txt += f"; REFUSES op {ids}"
                clients[str(cl)] = txt
            cfgs.append(
                {
                    "ord": ordmap,
                    "refused": refused_ids,
                    "clients": clients,
                    "label": (
                        f"{len(prefix)}/{n_checked} ops linearized; "
                        f"refused: {', '.join(map(str, refused_ids)) or '—'}"
                    ),
                }
            )
    cfg0_ord = cfgs[0]["ord"] if cfgs else {}

    n_events = max((op.ret for op in history.ops if not op.pending), default=1)
    n_events = max(n_events, max((op.call for op in history.ops), default=0) + 1)
    span = float(n_events + 1)

    lanes: list[str] = []
    for chain_id, members in enumerate(history.chains):
        if not members:
            continue
        client = history.ops[members[0]].client_id
        bars = []
        for op_index in sorted(members, key=lambda i: history.ops[i].call):
            op = history.ops[op_index]
            left = 100.0 * op.call / span
            right_ev = n_events + 1 if op.pending else op.ret + 1
            width = max(100.0 * (right_ev - op.call) / span, 0.45)
            ordinal = order_by_opid.get(op.op_id) or cfg0_ord.get(op.op_id)
            classes = ["op", _op_class(op)]
            if ordinal is not None or op.op_id in deepest_opids:
                classes.append("linearized")
            if op.op_id in refused_opids:
                classes.append("refused")
            base_tip = (
                f"op {op.op_id} (client {op.client_id})\n"
                f"{describe_operation(op.inp, op.out)}\n"
                f"window: call@{op.call} → "
                f"{'pending' if op.pending else f'ret@{op.ret}'}"
            )
            tip = base_tip
            if ordinal is not None:
                tip += f"\nlinearized at position {ordinal}"
            if op.op_id in refused_opids:
                tip += "\nREFUSED to linearize at the deepest prefix"
            ord_html = f'<span class="ord">{ordinal}</span>' if ordinal else ""
            tip_attr = html.escape(tip, quote=True).replace("\n", "&#10;")
            base_attr = html.escape(base_tip, quote=True).replace("\n", "&#10;")
            bars.append(
                f'<div class="{" ".join(classes)}" '
                f'style="left:{left:.3f}%;width:{width:.3f}%" '
                f'data-opid="{op.op_id}" data-basetip="{base_attr}" '
                f'data-tip="{tip_attr}">{ord_html}</div>'
            )
        lanes.append(
            f'<div class="lane"><div class="lane-label">client {client}</div>'
            f'<div class="lane-track">{"".join(bars)}</div></div>'
        )

    v = result.outcome.value
    verdict = f'<span class="verdict {v}">{v.upper()}</span>'
    pieces = [
        f"<h1>{html.escape(title)}</h1>",
        f'<div class="meta">{verdict} &nbsp; '
        f"{len(history.ops)} ops, {sum(1 for o in history.ops if o.pending)} pending, "
        f"{len([m for m in history.chains if m])} clients</div>",
        *lanes,
        '<div class="legend">'
        '<span class="chip" style="background:#9fd7ab"></span>success'
        '<span class="chip" style="background:#f3a6a3"></span>definite failure'
        '<span class="chip" style="background:#ffd488;border-style:dashed"></span>'
        "indefinite/pending"
        '<span class="chip" style="background:#fff;outline:2px solid #4164c9">'
        "</span>linearized"
        '<span class="chip" style="background:#fff;outline:2px dashed #a12622">'
        "</span>refused</div>",
    ]
    if result.ok and result.final_states:
        states = ", ".join(
            f"<code>{html.escape(describe_state(s))}</code>"
            for s in result.final_states
        )
        pieces.append(f'<div class="final">final states: {states}</div>')
    elif result.outcome in (CheckOutcome.ILLEGAL, CheckOutcome.UNKNOWN):
        # Partial-linearization outline, like porcupine.Visualize draws for
        # failed checks (main.go:608-631) — also for inconclusive runs
        # (budget or beam exhaustion), which the reference cannot produce.
        # An immediate failure has an EMPTY deepest prefix; the refusal
        # report below still names the culprit then.
        if result.deepest:
            pieces.append(
                f'<div class="final">deepest linearized prefix: '
                f"{len(result.deepest)} / "
                f"{sum(1 for o in checked.ops)} ops (outlined)</div>"
            )
        if refused_opids:
            ids = ", ".join(str(i) for i in sorted(refused_opids))
            n_cfg = len(result.refusals)
            # With the explorable view active, outlines follow the SELECTED
            # configuration — the union line must not promise outlines the
            # initial view doesn't draw.
            outline_note = (
                " (outlined per selected configuration)"
                if cfgs
                else " (red dashed outline)"
            )
            pieces.append(
                f'<div class="final">refusing to linearize at '
                f"{n_cfg} deepest configuration{'s' if n_cfg != 1 else ''}: "
                f"op{'s' if len(refused_opids) != 1 else ''} "
                f"<code>{html.escape(ids)}</code>{outline_note}</div>"
            )
        if cfgs:
            if len(cfgs) < len(result.refusals or []):
                pieces.append(
                    f'<div class="final">{len(cfgs)} of '
                    f"{len(result.refusals)} configurations explorable "
                    f"(the rest exceeded the path re-derivation budget)</div>"
                )
            # Explorable per-configuration view: the selector re-annotates
            # the timeline (ordinals, refused outlines, per-client
            # breakdown) for the chosen deepest configuration.
            if len(cfgs) > 1:
                opts = "".join(
                    f'<option value="{i}">configuration {i + 1}: '
                    f"{html.escape(c['label'])}</option>"
                    for i, c in enumerate(cfgs)
                )
                pieces.append(
                    f'<div class="final">explore deepest configuration: '
                    f'<select id="cfg-select">{opts}</select></div>'
                )
            else:
                pieces.append(
                    f'<div class="final">deepest configuration: '
                    f"{html.escape(cfgs[0]['label'])}</div>"
                )
            all_clients = sorted(
                {int(k) for c in cfgs for k in c["clients"]}
            )
            rows = "".join(
                f'<div>client {cl}: <span class="client-summary" '
                f'data-client="{cl}"></span></div>'
                for cl in all_clients
            )
            pieces.append(f'<div class="final">per client:{rows}</div>')
    panel = _frontier_panel(result)
    if panel:
        pieces.append(panel)
    panel = _shard_panel(result)
    if panel:
        pieces.append(panel)
    panel = _child_panel(result)
    if panel:
        pieces.append(panel)
    body = "\n".join(pieces)
    cfg_json = ""
    if cfgs:
        payload = json.dumps(cfgs).replace("</", "<\\/")
        cfg_json = (
            f'<script type="application/json" id="cfg-data">{payload}</script>'
        )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_CSS}</style></head>"
        f"<body>{body}<div id='tip'></div>{cfg_json}"
        f"<script>{_JS}</script></body></html>"
    )


def write_visualization(
    path: str,
    history: History,
    result: CheckResult,
    *,
    title: str = "s2 linearizability check",
    checked: History | None = None,
) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_html(history, result, title=title, checked=checked))
