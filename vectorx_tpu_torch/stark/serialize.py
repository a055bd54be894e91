"""STARK proof (de)serialization — the wire format.

Port of `vectorx_tpu.stark.serialize`, producing the same JSON: every proof
object is plain integers, so a proof round-trips through JSON losslessly,
and a proof crosses between the port and the reference package this way.
"""

from __future__ import annotations

from vectorx_tpu_torch.fri.fri import FriProof, FriQueryRound, FriQueryStep
from vectorx_tpu_torch.stark.prover import StarkProof, TreeOpening


def _pairs_out(pairs):
    return [[int(a), int(b)] for (a, b) in pairs]


def _pairs_in(rows):
    return [(int(a), int(b)) for a, b in rows]


def _openings_out(openings):
    return [{"leaf": [int(x) for x in o.leaf],
             "path": [[int(x) for x in sib] for sib in o.path]}
            for o in openings]


def _openings_in(rows):
    return [TreeOpening(leaf=[int(x) for x in r["leaf"]],
                        path=[[int(x) for x in sib] for sib in r["path"]])
            for r in rows]


def fri_proof_to_json(p: FriProof) -> dict:
    return {
        "caps": [[[int(x) for x in d] for d in cap] for cap in p.caps],
        "final_coeffs": _pairs_out(p.final_coeffs),
        "pow_witness": int(p.pow_witness),
        "query_rounds": [
            {"steps": [{"pair": [int(x) for x in s.pair],
                        "path": [[int(x) for x in sib] for sib in s.path]}
                       for s in qr.steps]}
            for qr in p.query_rounds],
    }


def fri_proof_from_json(d: dict) -> FriProof:
    return FriProof(
        caps=[[[int(x) for x in dig] for dig in cap] for cap in d["caps"]],
        final_coeffs=_pairs_in(d["final_coeffs"]),
        pow_witness=int(d["pow_witness"]),
        query_rounds=[
            FriQueryRound(steps=[
                FriQueryStep(pair=[int(x) for x in s["pair"]],
                             path=[[int(x) for x in sib]
                                   for sib in s["path"]])
                for s in qr["steps"]])
            for qr in d["query_rounds"]],
    )


def proof_to_json(p: StarkProof) -> dict:
    """StarkProof -> JSON-safe dict (every value an int/list/dict)."""
    return {
        "trace_cap": [[int(x) for x in d] for d in p.trace_cap],
        "quotient_cap": [[int(x) for x in d] for d in p.quotient_cap],
        "trace_at_zeta": _pairs_out(p.trace_at_zeta),
        "trace_at_zeta_next": _pairs_out(p.trace_at_zeta_next),
        "quotient_at_zeta": _pairs_out(p.quotient_at_zeta),
        "fri_proof": fri_proof_to_json(p.fri_proof),
        "trace_openings": _openings_out(p.trace_openings),
        "quotient_openings": _openings_out(p.quotient_openings),
        "constants_at_zeta": _pairs_out(p.constants_at_zeta),
        "constants_openings": _openings_out(p.constants_openings),
        "aux_cap": [[int(x) for x in d] for d in p.aux_cap],
        "aux_at_zeta": _pairs_out(p.aux_at_zeta),
        "aux_at_zeta_next": _pairs_out(p.aux_at_zeta_next),
        "aux_openings": _openings_out(p.aux_openings),
    }


def proof_from_json(d: dict) -> StarkProof:
    return StarkProof(
        trace_cap=[[int(x) for x in dig] for dig in d["trace_cap"]],
        quotient_cap=[[int(x) for x in dig] for dig in d["quotient_cap"]],
        trace_at_zeta=_pairs_in(d["trace_at_zeta"]),
        trace_at_zeta_next=_pairs_in(d["trace_at_zeta_next"]),
        quotient_at_zeta=_pairs_in(d["quotient_at_zeta"]),
        fri_proof=fri_proof_from_json(d["fri_proof"]),
        trace_openings=_openings_in(d["trace_openings"]),
        quotient_openings=_openings_in(d["quotient_openings"]),
        constants_at_zeta=_pairs_in(d["constants_at_zeta"]),
        constants_openings=_openings_in(d["constants_openings"]),
        aux_cap=[[int(x) for x in dig] for dig in d["aux_cap"]],
        aux_at_zeta=_pairs_in(d["aux_at_zeta"]),
        aux_at_zeta_next=_pairs_in(d["aux_at_zeta_next"]),
        aux_openings=_openings_in(d["aux_openings"]),
    )
