"""JobLedger on the port: the cases of ``tests/test_job_ledger.py``, and
journals that replay across the two packages (one workspace may be served
by either)."""

import json

import pytest

from semcode_tpu.api.jobs import JobLedger as JaxLedger
from semcode_tpu_torch.api.jobs import JobLedger


def test_lifecycle_fold():
    ledger = JobLedger()
    job = ledger.create("ingest", metadata={"name": "demo"})
    assert job.status == "queued" and job.metadata["name"] == "demo"
    ledger.set_status(job.id, "running", stage="copy")
    ledger.update_progress(job.id, files=3)
    ledger.update_progress(job.id, files=7, chunks=2)
    ledger.update_stage(job.id, "embed")
    snap = ledger.get(job.id)
    assert snap.status == "running" and snap.stage == "embed"
    assert dict(snap.progress) == {"files": 7, "chunks": 2}
    ledger.complete(job.id, {"chunk_count": 9})
    done = ledger.get(job.id)
    assert done.status == "completed" and done.result == {"chunk_count": 9}
    assert done.duration_ms() >= 0


def test_snapshots_are_immutable():
    ledger = JobLedger()
    job = ledger.create("ingest")
    ledger.set_status(job.id, "running")
    before = ledger.get(job.id)
    ledger.update_progress(job.id, files=1)
    assert dict(before.progress) == {}, "held snapshot must not mutate"
    with pytest.raises(TypeError):
        before.progress["x"] = 1  # frozen mapping


def test_terminal_states_are_sticky():
    ledger = JobLedger()
    job = ledger.create("ingest")
    ledger.fail(job.id, "boom")
    failed_at = ledger.get(job.id).updated_at
    ledger.update_progress(job.id, late_callback=True)  # no-op
    ledger.complete(job.id)  # cannot resurrect
    snap = ledger.get(job.id)
    assert snap.status == "failed" and snap.error == "boom"
    assert snap.updated_at == failed_at
    assert "late_callback" not in snap.progress


def test_unknown_job_raises():
    with pytest.raises(KeyError):
        JobLedger().set_status("nope", "running")


def test_journal_replay_restores_jobs(tmp_path):
    path = tmp_path / "jobs.jsonl"
    ledger = JobLedger(path)
    done = ledger.create("ingest", metadata={"name": "a"})
    ledger.set_status(done.id, "running")
    ledger.complete(done.id, {"chunk_count": 4})
    midflight = ledger.create("ingest", metadata={"name": "b"})
    ledger.set_status(midflight.id, "running", stage="embed")
    ledger.close()

    revived = JobLedger(path)  # simulated restart
    a = revived.get(done.id)
    assert a.status == "completed" and a.result == {"chunk_count": 4}
    assert a.metadata["name"] == "a"
    b = revived.get(midflight.id)
    assert b.status == "interrupted" and "exited" in b.error
    revived.close()
    third = JobLedger(path)  # the interruption verdict itself is persisted
    assert third.get(midflight.id).status == "interrupted"


def test_journal_tolerates_torn_tail(tmp_path):
    path = tmp_path / "jobs.jsonl"
    ledger = JobLedger(path)
    job = ledger.create("ingest")
    ledger.complete(job.id)
    ledger.close()
    with path.open("a") as f:
        f.write('{"id": "x", "kind": "crea')  # torn write from a crash
    assert JobLedger(path).get(job.id).status == "completed"


def test_progress_journal_throttled(tmp_path):
    path = tmp_path / "jobs.jsonl"
    ledger = JobLedger(path)
    job = ledger.create("ingest")
    ledger.set_status(job.id, "running")
    for i in range(200):  # burst of per-file callbacks
        ledger.update_progress(job.id, files=i)
    assert ledger.get(job.id).progress["files"] == 199  # the fold saw all
    ledger.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert len([e for e in events if e["kind"] == "progress"]) <= 2


def test_terminal_eviction_bounds_memory():
    ledger = JobLedger(keep_terminal=5)
    ids = []
    for _ in range(12):
        j = ledger.create("ingest")
        ledger.complete(j.id)
        ids.append(j.id)
    live = ledger.create("ingest")  # non-terminal: never evicted
    assert ledger.get(live.id) is not None
    assert [i for i in ids if ledger.get(i) is not None] == ids[-5:]


def test_journal_bounded_across_restarts(tmp_path):
    """Startup compaction folds the journal to one snapshot line per job."""
    journal = tmp_path / "jobs.jsonl"
    ledger = JobLedger(journal)
    for i in range(5):
        snap = ledger.create("ingest", {"n": i})
        ledger.set_status(snap.id, "running")
        for p in range(20):
            ledger.update_progress(snap.id, copied=p)
        ledger.complete(snap.id, {"ok": True})
    ledger.close()
    assert len(journal.read_text().splitlines()) >= 15
    for _ in range(3):
        ledger = JobLedger(journal)
        jobs = ledger.list()
        assert len(jobs) == 5
        assert all(s.status == "completed" and s.result == {"ok": True}
                   for s in jobs.values())
        ledger.close()
        assert len(journal.read_text().splitlines()) == 5


def test_journal_compaction_marks_interrupted(tmp_path):
    journal = tmp_path / "jobs.jsonl"
    ledger = JobLedger(journal)
    snap = ledger.create("ingest")
    ledger.set_status(snap.id, "running", stage="copy")
    ledger.close()  # process "dies" mid-job
    ledger2 = JobLedger(journal)
    assert ledger2.get(snap.id).status == "interrupted"
    ledger2.close()
    ledger3 = JobLedger(journal)
    assert ledger3.get(snap.id).status == "interrupted"
    ledger3.close()


# -- one journal, two packages ---------------------------------------------------


def _write_history(cls, path):
    """A journal with a completed, a failed and a mid-flight job, left
    without a clean close (the process died)."""
    ledger = cls(path)
    done = ledger.create("ingest", metadata={"name": "a", "include": ["src"]})
    ledger.set_status(done.id, "running", stage="initializing")
    ledger.update_progress(done.id, copy_processed=3, last_file="x.py")
    ledger.update_stage(done.id, "embedding")
    ledger.complete(done.id, {"name": "a", "chunk_count": 4})
    failed = ledger.create("ingest", metadata={"name": "b"})
    ledger.fail(failed.id, "Root path not found: /nowhere")
    mid = ledger.create("ingest", metadata={"name": "c"})
    ledger.set_status(mid.id, "running", stage="chunking")
    ledger.update_progress(mid.id, chunk_processed=2)
    return ledger, (done.id, failed.id, mid.id)


def _view(snap):
    return {k: getattr(snap, k) for k in
            ("id", "type", "status", "stage", "result", "error", "created_at")} | {
        "progress": dict(snap.progress), "metadata": dict(snap.metadata)}


@pytest.mark.parametrize("writer,reader", [(JaxLedger, JobLedger),
                                           (JobLedger, JaxLedger)],
                         ids=["jax_to_port", "port_to_jax"])
def test_journal_cross_replay(tmp_path, writer, reader):
    path = tmp_path / "jobs.jsonl"
    live, ids = _write_history(writer, path)
    live._journal.flush()  # the process dies here, without close()
    same = tmp_path / "same.jsonl"
    same.write_text(path.read_text())
    other = reader(path)
    own = writer(same)
    for job_id in ids:
        assert _view(other.get(job_id)) == _view(own.get(job_id))
    assert [other.get(i).status for i in ids] == ["completed", "failed", "interrupted"]
    assert "in flight" in other.get(ids[2]).error
    assert other.get(ids[0]).progress["copy_processed"] == 3
    other.close()
    own.close()
    # the reader's compacted journal replays in the writer's package too
    again = writer(path)
    assert [again.get(i).status for i in ids] == ["completed", "failed", "interrupted"]
    again.close()
    live.close()
