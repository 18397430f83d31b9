"""One rank of a client-sharded run of the port, for the two-rank tests.

    python tests/_torch_shard_worker.py CASES RANK WORLD STORE OUT

joins a gloo group of WORLD processes through the ``FileStore`` at STORE,
runs every case of the pickled CASES ({name: {"fn", "cfg", "init"}}) under
the group's client mesh on the CPU, one torch thread, and pickles each
case's result (tensors as numpy) to OUT with ``{rank}`` filled in.  The
cases' noise streams arrive as recorded tables (``replay_noise``,
``replay_codec_noise``), so no process but the test's imports JAX.
"""
import os
import pickle
import sys

import torch


def replay_noise(table):
    """``noise(stream, batch)`` of ``run_pfit`` from recorded draws:
    ``table[stream]`` is a list of (batch, vocab) arrays, one a step."""
    def noise(stream, batch):
        draws = [torch.from_numpy(a) for a in table[stream]]
        return lambda step: draws[step]
    return noise


def replay_codec_noise(table):
    """``codec_noise(round, client, leaf, shape)`` from recorded uniforms."""
    return lambda rnd, ci, leaf, shape: table[(rnd, ci, leaf)]


def _plain(x):
    """A result made picklable without torch: tensors to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def run_case(case, mesh):
    from repro_torch.core import arch_round, pfit, pftt
    init = dict(case.get("init") or {})
    if "noise_table" in init:
        init["noise"] = replay_noise(init.pop("noise_table"))
    if "codec_table" in init:
        init["codec_noise"] = replay_codec_noise(init.pop("codec_table"))
    fn = {"pftt": pftt.run_pftt, "pfit": pfit.run_pfit,
          "arch": arch_round.run_arch_round}[case["fn"]]
    return fn(case["cfg"], init=init or None, mesh=mesh)


def main(argv):
    cases_file, rank, world, store_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import client_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = client_mesh()
        with open(cases_file, "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, case in cases.items():
            results[name] = _plain(run_case(case, mesh))
        tmp = out.format(rank=rank) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(results, f)
        os.replace(tmp, out.format(rank=rank))
    finally:
        dist.destroy_process_group()


def spawn_ranks(cases, tmp_path, world=2, timeout=900):
    """Run ``cases`` on ``world`` worker processes; → each rank's results."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    tmp_path.mkdir(parents=True, exist_ok=True)
    cases_file = str(tmp_path / "cases.pkl")
    with open(cases_file, "wb") as f:
        pickle.dump(cases, f)
    out = str(tmp_path / "rank{rank}.pkl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, here] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), cases_file, str(r),
                               str(world), str(tmp_path / "store"), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    results = []
    for r in range(world):
        with open(out.format(rank=r), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
