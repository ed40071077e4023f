"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
served requests, drawn from the seed with the one that received most
tokens in it, is replayed by the plain reference (``bench/reference``)
from its prompt and the tokens the program served: the reference's own
chunked prefill, then the decode ticks fed the served tokens.  At every
served token the reference's logits are read, and the number compared is
the widest gap by which a served token's logit lies below the reference's
best (0 where the reference would have chosen the same token).  The
weights are drawn again from the seed: the reference takes nothing the
program made.

A mixture-of-experts engine routes the slots of one decode tick together,
so what a served token met depends on the other slots of its ticks.  The
reference then follows the program's schedule (which request each slot
held on each tick, the token each slot fed and its position), and checks
the part of it that the served tokens determine: on every tick a sampled
request sat in, its slot fed its previous served token at the position
after its prompt and the tokens before it.  The trunk of each such tick
is recomputed over all its slots.

Where the mix asks (``snapshot_prefill``), the reference's decode starts
from the program's prefilled cache, read through its block table right
after its prefill: ThinKV's eviction turns last-bit differences between
the program's prefill kernels and plain attention into other retained
tokens, and the two would attend different caches from then on.  The
prefill is then judged by itself: at the first token, from the
reference's own prefill, and by :func:`state_diff` (printed, no limit).

``control`` is the same comparison with the reference computed at TF32
(``tf32=True``) in the program's place: at each position the token the
TF32 reference puts first is judged by the f32 reference's logits.  Its
numbers go through the same :func:`verdict` as a run's, under the same
names, so a control run comes out not correct where the limits hold.

Where the mix samples (``temperature`` above 0), a served token is not the
reference's first, and ``logit_gap`` would only read the draw: the number
is then ``nucleus_excess``, how far the reference's probability mass
strictly above the served token (at the mix's temperature) passes the
mix's ``top_p``; the program's sampler never emits a token past its
nucleus, so a sound run reads at most rounding above 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchlib import model, traffic
from reference import thinkv_ref as R


def sample(served, mix: dict, seed: int) -> list:
    """Requests to compare: finished ones where the mix finishes any
    (all that received tokens otherwise), the one with most tokens first,
    then others drawn from the seed until ``sample_requests`` requests and
    ``sample_tokens`` tokens are reached (at most twice that many)."""
    cands = [r for r in served if r.finished] or \
        [r for r in served if len(r.tokens) > 1]
    if not cands:
        return []
    cands.sort(key=lambda r: (-len(r.tokens), r.arrival))
    rng = np.random.default_rng(int(seed) + 1)
    rest = [cands[i] for i in 1 + rng.permutation(len(cands) - 1)]
    out = [cands[0]]
    for r in rest:
        if len(out) >= mix["sample_requests"] and \
                sum(len(x.tokens) for x in out) >= mix["sample_tokens"]:
            break
        if len(out) >= 2 * mix["sample_requests"]:
            break
        out.append(r)
    return out


def _moe_trunks(ref: R.Reference, schedule, reqs, slots: int,
                device) -> Tuple[Dict[int, dict], int]:
    """Each sampled request's decode trunk rows {t: (q, k, v, h)} from the
    ticks it sat in, each tick's trunk computed over all its slots as the
    engine routes them; and the count of schedule entries that disagree
    with the served tokens."""
    by_arrival = {r.arrival: r for r in reqs}
    rows: Dict[int, dict] = {a: {} for a in by_arrival}
    bad = 0
    for arrivals, feed, ntok in schedule:
        if not any(a in by_arrival for a in arrivals):
            continue
        q, k, v, h = ref.trunk(torch.as_tensor(feed, device=device),
                               torch.as_tensor(ntok, device=device))
        for s, a in enumerate(arrivals):
            if a not in by_arrival:
                continue
            r = by_arrival[a]
            t = int(ntok[s]) - len(r.prompt)
            if not 0 <= t < len(r.tokens) or int(feed[s]) != r.tokens[t]:
                bad += 1
                continue
            rows[a][t] = tuple(x.clone() for x in (
                q[:, s], k[:, s], v[:, s], h[s]))
    return rows, bad


def _dense_trunk(ref: R.Reference, tokens, pos, slots: int):
    """A request's decode trunk rows, computed in calls of ``slots`` rows
    (the engine's tick shape; the last call padded)."""
    T = len(tokens)
    pad = -T % slots
    tokens = torch.cat([tokens, tokens.new_zeros(pad)])
    pos = torch.cat([pos, pos.new_zeros(pad)])
    parts = [ref.trunk(tokens[i:i + slots], pos[i:i + slots])
             for i in range(0, T + pad, slots)]
    q, k, v = (torch.cat([p[i] for p in parts], 1)[:, :T] for i in range(3))
    return q, k, v, torch.cat([p[3] for p in parts])[:T]


def state_diff(a: dict, b: dict) -> float:
    """Share of the (layer, slot) places VALID in either of two prefilled
    caches where they differ: VALID in one only, or codes that differ."""
    va, vb = a["state"] == R.VALID, b["state"] == R.VALID
    codes = ((a["k_codes"] != b["k_codes"]) |
             (a["v_codes"] != b["v_codes"])).flatten(2).any(-1)
    diff = (va != vb) | (va & vb & codes)
    return float(diff.sum()) / max(1, int((va | vb).sum()))


def _prefilled(cache: R.Cache) -> dict:
    return {"state": cache.state.clone(), "k_codes": cache.k_codes.clone(),
            "v_codes": cache.v_codes.clone()}


def replay(arch: dict, tk: dict, serving: dict, weights, reqs, schedule,
           snapshots: dict, tf32: bool = False, against=None):
    """The reference's logits at every served token of each request
    ([n_tokens, V] each: the prompt's last position, then each decode
    tick), the count of schedule entries that disagree, and, for the
    requests with a snapshot, the reference's own prefilled caches and how
    far each lies from the snapshot (from ``against[i]`` instead, when
    given)."""
    dev = weights["embedding"].device
    ref = R.Reference(arch, tk, weights, tf32=tf32)
    moe_rows, bad = {}, 0
    if "experts" in arch:
        moe_rows, bad = _moe_trunks(ref, schedule, reqs,
                                    serving["max_seqs"], dev)
    out, own, diffs = [], [], []
    for i, r in enumerate(reqs):
        cache = R.Cache(tk, arch["layers"], arch["kv_heads"],
                        arch["head_dim"], dev)
        prompt = torch.as_tensor(r.prompt, device=dev)
        logits = [ref.prefill(cache, prompt, serving["prefill_chunk"])[None]]
        snap = snapshots.get(r.arrival)
        if snap is not None:
            # decode from the program's prefilled cache; the prefill itself
            # is judged by itself: at the first token, and by how far the
            # snapshot lies from the reference's own prefilled cache
            bad += int(snap["num_tokens"] != len(r.prompt))
            own.append(_prefilled(cache))
            diffs.append(state_diff(own[-1], snap if against is None
                                    else against[i]))
            cache = R.Cache(tk, arch["layers"], arch["kv_heads"],
                            arch["head_dim"], dev).load(snap)
        T = len(r.tokens) - 1
        if "experts" in arch:
            have, n = moe_rows[r.arrival], 0
            while n < T and n in have:
                n += 1
            bad, T = bad + T - n, n          # ticks the schedule lacks
        if T > 0:
            if "experts" in arch:
                parts = [moe_rows[r.arrival][t] for t in range(T)]
                q, k, v = (torch.stack([p[i] for p in parts], 1)
                           for i in range(3))
                h = torch.stack([p[3] for p in parts])
            else:
                q, k, v, h = _dense_trunk(
                    ref, torch.as_tensor(r.tokens[:T], device=dev),
                    len(r.prompt) + torch.arange(T, device=dev),
                    serving["max_seqs"])
            logits.append(ref.decode(cache, q, k, v, h))
        out.append(torch.cat(logits))
    return out, bad, own, diffs


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far the chosen token's logit lies below the best, per row."""
    return logits.max(-1).values - logits.gather(1, chosen[:, None])[:, 0]


def excess(logits: torch.Tensor, chosen: torch.Tensor, temperature: float,
           top_p: float) -> torch.Tensor:
    """Per row, the probability mass (at ``temperature``) of the tokens
    strictly more likely than the chosen one, less ``top_p``: above 0 the
    chosen token lies outside the nucleus."""
    probs = torch.softmax(logits.double() / temperature, -1)
    own = probs.gather(1, chosen[:, None])
    return (probs * (probs > own)).sum(-1) - top_p


def _read(all_gaps: List[torch.Tensor]) -> Tuple[float, float]:
    """(the widest gap, the share of positions whose token is not the
    reference's first)."""
    g = torch.cat(all_gaps)
    return float(g.max()), float((g > 0).float().mean())


def run(arch, tk, serving, mix, seed, reqs, schedule, snapshots, device,
        control: bool = False) -> Tuple[Dict[str, float],
                                        Optional[Dict[str, float]]]:
    """The numbers compared, of the program and (with ``control``) of the
    TF32 reference in its place, under the same names: greedy,
    ``logit_gap`` (the widest gap) and ``mismatch_share`` (the share of
    served tokens the reference would not have chosen); sampled,
    ``nucleus_excess`` (the largest :func:`excess`); ``prefill_state_diff``
    where the decode starts from the program's prefilled caches (the
    widest :func:`state_diff` of a snapshot from the reference's own
    prefill; the control's: its own prefilled caches against the f32
    reference's); ``schedule_bad`` and ``compared_tokens``."""
    temperature, top_p = traffic.sampling(mix)
    weights = model.draw(arch, seed, device)
    logits, bad, own, diffs = replay(arch, tk, serving, weights, reqs,
                                     schedule, snapshots)
    served = [torch.as_tensor(r.tokens[:lg.shape[0]], device=lg.device)
              for lg, r in zip(logits, reqs)]
    out = {"schedule_bad": float(bad),
           "compared_tokens": float(sum(lg.shape[0] for lg in logits))}
    if temperature > 0:
        out["nucleus_excess"] = float(torch.cat([
            excess(lg, t, temperature, top_p)
            for lg, t in zip(logits, served)]).max()) if served else 0.0
    else:
        out["logit_gap"], out["mismatch_share"] = _read(
            [gaps(lg, t) for lg, t in zip(logits, served)])
    if diffs:
        out["prefill_state_diff"] = max(diffs)
    if not control:
        return out, None
    if temperature > 0:
        raise ValueError("the TF32 control reads the tokens it puts first, "
                         "which a sampled mix's limits do not judge")
    low, _, _, low_diffs = replay(arch, tk, serving, weights, reqs,
                                  schedule, snapshots, tf32=True,
                                  against=own)
    ctl = {k: out[k] for k in ("schedule_bad", "compared_tokens")}
    ctl["logit_gap"], ctl["mismatch_share"] = _read(
        [gaps(f, c.argmax(-1)) for f, c in zip(logits, low)])
    if low_diffs:
        ctl["prefill_state_diff"] = max(low_diffs)
    return out, ctl


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """Each number beside its limit (None where the cell's limits compare
    it not); correct when none passes its limit and something was
    compared."""
    checks = {k: {"value": numbers[k], "limit": limits.get(k)}
              for k in ("logit_gap", "mismatch_share", "nucleus_excess",
                        "prefill_state_diff", "schedule_bad")
              if k in numbers}
    ok = all(c["value"] <= c["limit"] for c in checks.values()
             if c["limit"] is not None) and \
        numbers.get("compared_tokens", 0) > 0 and \
        all(k in numbers for k in limits)
    return ok, checks
