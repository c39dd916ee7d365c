"""Port parity: fault campaigns and their ground-truth labels.

Every builtin campaign, through the port's ``collect_labeled``, gives the
bytes and the label that the JAX package's gives for the same seed; each
conclusive label equals the port's CPU oracle verdict on that history
(legal ⇒ OK, illegal ⇒ ILLEGAL).  The streamed file and its
``.label.json`` sidecar equal the buffered run, and ``collect --campaign``
writes both.
"""

import io
import json

import pytest

from s2_verification_tpu.collector import campaign as jcampaign
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu_torch import cli
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check_events
from s2_verification_tpu_torch.collector import campaign as pcampaign
from s2_verification_tpu_torch.utils import events as pev


def _jsonl(events, codec) -> str:
    buf = io.StringIO()
    codec.write_history(events, buf)
    return buf.getvalue()


def test_builtin_matrix_is_the_jax_matrix():
    jm, pm = jcampaign.builtin_campaigns(), pcampaign.builtin_campaigns()
    assert sorted(pm) == sorted(jm)
    for name in pm:
        assert repr(pm[name]) == repr(jm[name])
    assert pcampaign.VIOLATION_CLASSES == jcampaign.VIOLATION_CLASSES


@pytest.mark.parametrize("seed", [1, 11])
@pytest.mark.parametrize("name", sorted(pcampaign.builtin_campaigns()))
def test_campaign_bytes_and_label_equal_jax_and_oracle(name, seed):
    events, label = pcampaign.collect_labeled(pcampaign.get_campaign(name), seed)
    jevents, jlabel = jcampaign.collect_labeled(jcampaign.get_campaign(name), seed)
    assert _jsonl(events, pev) == _jsonl(jevents, jev)
    assert label == jlabel
    if label["expect"] == "unknown":
        return
    want = CheckOutcome.ILLEGAL if label["expect"] == "illegal" else CheckOutcome.OK
    assert check_events(events).outcome == want


def test_streamed_campaign_and_sidecar(tmp_path, capsys):
    c = pcampaign.get_campaign("stale-read")
    path, lpath, label = pcampaign.collect_labeled_to_file(c, seed=11, out_dir=str(tmp_path))
    assert lpath == pcampaign.label_path_for(path) == path + ".label.json"
    events, mem_label = pcampaign.collect_labeled(c, seed=11)
    with open(path, encoding="utf-8") as f:
        assert f.read() == _jsonl(events, pev)
    with open(lpath, encoding="utf-8") as f:
        assert json.load(f) == label == mem_label
    assert label["expect"] == "illegal"

    rc = cli.main(["collect", "--campaign", "reorder", "--seed", "2", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out.strip()
    assert rc == 0
    with open(pcampaign.label_path_for(out), encoding="utf-8") as f:
        assert json.load(f)["campaign"] == "reorder"
