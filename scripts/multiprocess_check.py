"""Execute the multi-PROCESS distributed path.

The reference's only scaling mechanism is worker tasks inside one process
(renderer/renderer.rs:62-78); this design scales across hosts via
`jax.distributed.initialize` + a global device mesh (parallel/sharded.py).
tests/test_scaling_evidence.py pins the collective structure of
single-process meshes; this script runs the REAL
multi-process runtime — 2 processes x 4 CPU devices each, one global
8-device mesh over a distributed coordinator — and gates:

  1. the sharded Cornell forward over the 2-process tile mesh is BITWISE
     equal to the single-device render_image oracle (the same gate the
     single-process tests apply: tile sharding must not change a pixel);
  2. a (4 tile x 2 sample) mesh that splits spp ACROSS THE PROCESS
     BOUNDARY matches the oracle within 1 ulp (f32 summation order in the
     cross-process pmean is the only permitted difference);
  3. both processes observe identical bytes (the psum/pmean ran across
     processes — here over the local loopback transport — not as
     per-process replicas).

Run with no arguments: spawns the 2 worker processes (itself, --worker N)
on CPU with xla_force_host_platform_device_count=4 and prints one JSON
line with the results. Exit code 0 = all gates passed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(idx: int, n_proc: int, port: int) -> None:
    import jax

    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc,
        process_id=idx,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from tinyraytracer_tpu.models import presets
    from tinyraytracer_tpu.ops import trace as trace_ops
    from tinyraytracer_tpu.parallel import sharded

    assert jax.process_count() == n_proc, jax.process_count()
    assert len(jax.devices()) == 4 * n_proc, len(jax.devices())
    assert len(jax.local_devices()) == 4

    w = h = 48
    spp, mb = 4, 4
    world, cam, kw = presets.cornell_box(width=w, height=h)
    scene = world.build()
    bg = jnp.asarray(kw["background"], jnp.float32)

    # single-device oracle (computed identically in every process)
    ref = np.asarray(
        trace_ops.render_image(
            scene, cam, spp=spp, max_bounces=mb, background=bg, seed=7))

    results = {}
    for name, sample_parallel, gate in (
            ("tile8", 1, "bitwise"), ("tile4_sample2", 2, "ulp")):
        mesh = sharded.make_mesh(jax.devices(),
                                 sample_parallel=sample_parallel)
        img = sharded.render_image_sharded(
            scene, cam, spp=spp, max_bounces=mb, background=bg, seed=7,
            mesh=mesh)
        # out shards live on different processes: gather the full global
        # image to every host over the distributed transport
        img_full = np.asarray(
            multihost_utils.process_allgather(img, tiled=True))
        assert img_full.shape == (h, w, 3), img_full.shape
        diff = np.abs(img_full - ref)
        if gate == "bitwise":
            ok = bool(np.array_equal(img_full, ref))
        else:
            a = img_full.view(np.int32).astype(np.int64)
            b = ref.view(np.int32).astype(np.int64)
            ok = bool(np.max(np.abs(a - b)) <= 1)
        results[name] = {
            "ok": ok,
            "max_abs_diff": float(diff.max()),
            "sha256": hashlib.sha256(img_full.tobytes()).hexdigest(),
        }

    # gate 3: both processes must hold identical bytes
    digests = multihost_utils.process_allgather(
        jnp.frombuffer(
            bytes.fromhex(results["tile8"]["sha256"]), dtype=jnp.uint8),
        tiled=False)
    digests = np.asarray(digests).reshape(n_proc, -1)
    results["cross_process_identical"] = bool(
        (digests == digests[0]).all())

    # gate 4: a TRAIN step across the process boundary (BASELINE
    # config 5's "sharded across >= 2 hosts", to the letter). The
    # modular sharded step runs on the global mesh — scene-gradient
    # psum crosses the process boundary — and its loss must match the
    # single-process, single-device step to collective-reassociation
    # tolerance; the replicated post-step params must be identical
    # bytes on both processes.
    from tinyraytracer_tpu.diff import inverse

    tgt = jnp.zeros((h, w, 3), jnp.float32)
    mesh = sharded.make_mesh(jax.devices(), sample_parallel=2)
    tstep, (tp, topt) = inverse.make_train_step(
        scene, cam, tgt, spp=spp, max_bounces=mb, background=bg,
        seed=0, mesh=mesh)
    tp, topt, tloss = tstep(tp, topt, 0)
    jax.block_until_ready((tp, topt))
    sstep, (sp, sopt) = inverse.make_train_step(
        scene, cam, tgt, spp=spp, max_bounces=mb, background=bg,
        seed=0)
    sp, sopt, sloss = sstep(sp, sopt, 0)
    rel = abs(float(tloss) - float(sloss)) / max(abs(float(sloss)), 1e-12)
    pbytes = np.ascontiguousarray(
        np.asarray(tp["sph_center"], np.float32)).tobytes()
    pdig = multihost_utils.process_allgather(
        jnp.frombuffer(hashlib.sha256(pbytes).digest(), dtype=jnp.uint8),
        tiled=False)
    pdig = np.asarray(pdig).reshape(n_proc, -1)
    results["train_step"] = {
        "loss_sharded": float(tloss),
        "loss_single": float(sloss),
        "loss_rel_diff": rel,
        "ok": bool(np.isfinite(float(tloss)) and rel <= 1e-5),
        "params_cross_process_identical": bool((pdig == pdig[0]).all()),
    }

    if idx == 0:
        print("WORKER0 " + json.dumps(results), flush=True)
    ok = (results["tile8"]["ok"] and results["tile4_sample2"]["ok"]
          and results["cross_process_identical"]
          and results["train_step"]["ok"]
          and results["train_step"]["params_cross_process_identical"])
    sys.exit(0 if ok else 1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port (default: a free local port)")
    args = ap.parse_args()
    if args.worker >= 0:
        worker(args.worker, args.num_processes, args.port)
        return
    port = args.port or _free_port()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=repo + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--num-processes",
             str(args.num_processes), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(args.num_processes)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    payload = None
    for line in outs[0].splitlines():
        if line.startswith("WORKER0 "):
            payload = json.loads(line[len("WORKER0 "):])
    summary = {
        "num_processes": args.num_processes,
        "devices_per_process": 4,
        "worker_rcs": rcs,
        "results": payload,
        "ok": all(rc == 0 for rc in rcs) and payload is not None,
    }
    print(json.dumps(summary))
    if not summary["ok"]:
        for i, o in enumerate(outs):
            sys.stderr.write(f"--- worker {i} output ---\n{o}\n")
        sys.exit(1)


if __name__ == "__main__":
    main()
