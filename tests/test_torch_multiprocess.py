"""The port's ("dcn", "data") mesh across two real processes (Gloo on the CPU).

Mirrors ``tests/integration/test_multiprocess_mesh.py``'s serving half: two
OS processes join one ``torch.distributed`` process group through
``parallel/distributed.maybe_init_distributed`` (worker 0 binds its own
coordinator port and announces it), build the ``(2, 4)`` mesh with four CPU
shards each, and run the flat scan (plain and filtered, both routes), IVF
probing and exact search, the chained batched probe search, the lexical
rerank's sharded fingerprint gather, and a VectorStore whose mesh comes from
the ``[mesh]`` settings. Every result must equal the same engine's on the
single-process ``(2, 4)`` mesh of ``[cpu] * 8``, bit for bit, in both
workers. A second run checks the memory split: each worker's index tensors
hold its own 4 shards, half of every index's rows and clusters, and the
snapshots it gathers equal the single-process ones bit for bit. Every
spawn has a timeout, and each worker destroys its process group in
``finally``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

ENGINE = r'''
def run_engine(mesh, store_cfg, store_mesh=None):
    import numpy as np
    import torch
    from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.lexical import (
        LexicalFingerprints, featurize_queries, featurize_query_symbols,
        rerank_device,
    )
    from semcode_tpu_torch.index.store import VectorStore

    rng = np.random.default_rng(42)  # identical inputs in every process
    x = rng.standard_normal((2048, 128)).astype(np.float32)
    x[500:520] = x[1500:1520]  # ties across the process boundary
    q = x[:8] + 0.01 * rng.standard_normal((8, 128)).astype(np.float32)
    q[1] = x[1505]
    tags = (np.arange(2048) % 2).astype(np.int32)
    out = {}

    def put(name, pair):
        s, i = (np.asarray(a) for a in pair)
        out[name] = [s.astype(np.float64).tolist(), i.astype(np.int64).tolist()]

    for dtype, impl in (("float32", "xla"), ("int8", "pallas")):
        flat = FlatIndex(128, metric="ip", dtype=dtype, scan_impl=impl, mesh=mesh)
        flat.add(x, tags=tags)
        put(f"flat_{dtype}", flat.search(q, k=5))
        put(f"flat_{dtype}_tag1", flat.search(q, k=5, allow_tags=[1]))
    ivf = IVFIndex(128, nlist=16, nprobe=16, metric="ip", dtype="int8",
                   use_pallas="always", mesh=mesh)
    ivf.add(x)
    for mode in ("ivf", "exact"):
        put(f"ivf_{mode}", ivf.search(q, k=5, mode=mode))
    qs = torch.from_numpy(np.stack([q, q[::-1].copy()]))
    s, i = ivf.search_device_batched(qs, 5, mode="probe")
    put("ivf_batched", (s.numpy(), i.numpy()))

    metas = [{"text": f"def sym_{i}(): pass", "symbol": f"sym_{i}",
              "path": f"m{i}.py"} for i in range(2048)]
    lex = LexicalFingerprints(128, kterms=16, mesh=mesh)
    lex.set_rows(np.arange(2048), metas)
    scores, rids = flat.search_device(torch.from_numpy(q), k=64)
    target = int(rids[0, 5])
    texts = [f"where is sym_{target} defined"] + [None] * 7
    s2, i2 = rerank_device(lex.device_arrays(flat.rows_allocated), scores, rids,
                           featurize_queries(texts),
                           q_sym=featurize_query_symbols(texts), weight=0.8,
                           mesh=mesh)
    put("rerank", (s2.numpy(), i2.numpy()))
    out["rerank_target"] = target

    # without a mesh the store builds one from the [mesh] settings
    store = VectorStore(store_cfg, dim=128, mesh=store_mesh, device="cpu")
    store.connect()
    out["store_mesh"] = [list(store._mesh.axis_names),
                         list(store._mesh.devices.shape)]
    vecs = x[:300] / np.linalg.norm(x[:300], axis=1, keepdims=True)
    store.upsert_embeddings([
        EmbeddingPayload(id=f"c{i}", text=f"def sym_{i}(): pass", vector=vecs[i],
                         metadata={"repo": f"r{i % 2}", "path": f"m{i}.py",
                                   "symbol": f"sym_{i}", "language": "python"})
        for i in range(300)
    ])
    hits = store.search_batch(vecs[:4], top_k=5, query_texts=[
        "sym_7", None, "where is sym_250 defined", None])
    out["store"] = [[h.id for h in hs] for hs in hits]
    out["store_filtered"] = [[h.id for h in hs] for hs in store.search_batch(
        vecs[:4], top_k=5, filters={"repo": "r1"})]
    return out
'''

LAYOUT = r'''
def run_layout(mesh):
    import hashlib
    import numpy as np
    from semcode_tpu_torch.index.flat import FlatIndex
    from semcode_tpu_torch.index.ivf import IVFIndex
    from semcode_tpu_torch.index.lexical import LexicalFingerprints
    from semcode_tpu_torch.parallel.mesh import ShardedRows

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2048, 128)).astype(np.float32)
    q = x[:8] + 0.01 * rng.standard_normal((8, 128)).astype(np.float32)
    out = {"held": {}, "answers": {}, "states": {}}

    def held(name, state):
        """(shards, rows held here, global rows) of every ShardedRows."""
        found = []

        def walk(obj):
            if isinstance(obj, ShardedRows):
                found.append([sorted(obj.parts),
                              sum(p.shape[0] for p in obj.parts.values()),
                              obj.rows])
            elif isinstance(obj, tuple):
                for v in obj:
                    walk(v)

        walk(state)
        out["held"][name] = found

    def digest(name, state):
        out["states"][name] = {
            k: [str(v.dtype), list(v.shape),
                hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()]
            if isinstance(v, np.ndarray) else v
            for k, v in state.items()}

    flat = FlatIndex(128, dtype="int8", rescore_mode="f32", scan_impl="pallas",
                     mesh=mesh)
    flat.add(x[:1000])
    flat.add(x[1000:])  # grows: every shard's range moves
    flat.remove(np.arange(0, 2048, 9))
    ivf = IVFIndex(128, nlist=16, nprobe=4, dtype="int8", use_pallas="always",
                   mesh=mesh)
    ivf.add(x[:1500])
    ivf.add(x[1500:])  # the mirror grows across the processes' shards
    ivf.remove(np.arange(3, 2048, 11))
    packed, _ = ivf.compacted()  # rows move to other shards' positions
    lex = LexicalFingerprints(128, kterms=16, mesh=mesh)
    lex.set_rows(np.arange(2048), [{"text": f"def f_{i}(): pass", "symbol": f"f_{i}",
                                    "path": f"m{i % 7}.py"} for i in range(2048)])
    lex.device_arrays(2048)
    for name, idx in (("flat", flat), ("ivf", ivf), ("ivf_compacted", packed)):
        held(name, idx._dev)
        digest(name, idx.state_dict())  # gathered from every process's shards
        for mode in ("ivf", "exact") if name != "flat" else ("exact",):
            kw = {} if name == "flat" else {"mode": mode}
            s, i = idx.search(q, 10, **kw)
            out["answers"][f"{name}_{mode}"] = [s.astype(np.float64).tolist(),
                                                i.tolist()]
    held("lexical", lex._dev)
    out["lexical_host"] = [hashlib.sha256(a.take(np.arange(a.rows)).numpy().tobytes()).hexdigest()
                           for a in lex.device_arrays(0)]
    return out
'''

WORKER = r'''
import json, socket, sys
sys.path.insert(0, {repo!r})
rank = int(sys.argv[1])
if rank == 0:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    print(f"PORT={{port}}", flush=True)
else:
    port = int(sys.argv[2])
from semcode_tpu_torch.parallel import distributed
from semcode_tpu_torch.parallel.mesh import make_mesh
from semcode_tpu_torch.settings import AppSettings

cfg = AppSettings(mesh_num_processes=2, mesh_coordinator=f"127.0.0.1:{{port}}",
                  mesh_process_id=rank, index_kind="flat", workspace_root=None,
                  index_snapshot_dir=None)
try:
    assert distributed.maybe_init_distributed(cfg, device="cpu")
    assert distributed.multihost_mesh_shape(cfg, device="cpu") == (
        (2, 1), ("dcn", "data"))
    mesh = make_mesh((2, 4), ("dcn", "data"), devices=["cpu"] * 4)
    assert (mesh.process_index, mesh.process_count) == (rank, 2)
    print("RESULT " + json.dumps({call}), flush=True)
finally:
    distributed.shutdown()
'''


def _spawn(tmp_path, code=ENGINE, call="run_engine(mesh, cfg)"):
    code = code + WORKER.format(repo=str(REPO), call=call)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMCODE_")}
    env["PYTHONPATH"] = str(REPO)
    procs, outs = [], []
    try:
        p0 = subprocess.Popen([sys.executable, "-c", code, "0"], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        procs.append(p0)
        port = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = p0.stdout.readline()
            if not line:
                break
            if line.startswith("PORT="):
                port = int(line.strip().split("=", 1)[1])
                break
        if port is None:
            p0.kill()
            return None, "worker 0 never printed its coordinator port:\n" + \
                p0.communicate(timeout=30)[0][-2500:]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, "1", str(port)], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        return None, "the two-process run timed out"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for n, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            return None, f"worker {n} failed (rc {p.returncode}):\n{out[-2500:]}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results, None


def test_two_process_gloo_mesh_equals_single_process(tmp_path):
    results, err = None, None
    for _ in range(2):  # one retry: the port probe has a tiny reuse window
        results, err = _spawn(tmp_path)
        if results is not None:
            break
    assert results is not None, err
    assert results[0] == results[1]  # every process holds the merged answer

    from semcode_tpu_torch.parallel.mesh import make_mesh
    from semcode_tpu_torch.settings import AppSettings

    namespace = {}
    exec(ENGINE, namespace)
    cfg = AppSettings(index_kind="flat", workspace_root=None,
                      index_snapshot_dir=None)
    # the settings give each process one CPU shard: a (2, 1) store mesh
    want = namespace["run_engine"](
        make_mesh((2, 4), ("dcn", "data"), devices=["cpu"] * 8), cfg,
        store_mesh=make_mesh((2, 1), ("dcn", "data"), devices=["cpu"] * 2))
    assert results[0]["store_mesh"] == want["store_mesh"] == [["dcn", "data"], [2, 1]]
    assert results[0].keys() == want.keys()
    for key in want:
        assert results[0][key] == want[key], key
    # the rerank lifted the named symbol to rank 1; query 0 is row 0's
    assert want["rerank"][1][0][0] == want["rerank_target"]
    assert want["flat_float32"][1][0][0] == 0 == want["ivf_exact"][1][0][0]


def test_two_processes_each_hold_half_of_every_index():
    """Each worker allocates its own 4 shards' tensors and no others: half
    of the flat rows, the IVF mirror rows and clusters (before and after a
    compaction that moves rows between the processes' shards) and the
    lexical table. Answers, rank 0's gathered snapshots and the gathered
    lexical table equal one process's on the (2, 4) mesh, bit for bit."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        results, err = None, None
        for _ in range(2):  # one retry: the port probe has a tiny reuse window
            results, err = _spawn(tmp, LAYOUT, "run_layout(mesh)")
            if results is not None:
                break
    assert results is not None, err

    from semcode_tpu_torch.parallel.mesh import make_mesh

    namespace = {}
    exec(LAYOUT, namespace)
    want = namespace["run_layout"](
        make_mesh((2, 4), ("dcn", "data"), devices=["cpu"] * 8))
    for name, entries in want["held"].items():
        assert entries and all(ranks == list(range(8)) and rows == total
                               for ranks, rows, total in entries), name
    for rank, got in enumerate(results):
        for name, entries in got["held"].items():
            assert len(entries) == len(want["held"][name]), name
            for ranks, rows, total in entries:
                assert ranks == list(range(4 * rank, 4 * rank + 4)), name
                assert 2 * rows == total, name
        assert got["answers"] == want["answers"]
        assert got["lexical_host"] == want["lexical_host"]
    assert results[0]["states"] == want["states"]
    assert results[1]["states"] == want["states"]
