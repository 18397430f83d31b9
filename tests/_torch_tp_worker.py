"""One rank of the tensor-parallel tests of the port.

    python tests/_torch_tp_worker.py CASES RANK WORLD STORE OUT

joins a gloo group of WORLD (4) processes through the ``FileStore`` at
STORE, builds the (2, 2) and (1, 4) meshes (``MeshCtx.create``; the
(1, 1) mesh runs on rank 0 alone), runs every case of the pickled CASES
({name: {"kind", "meshes", ...}}) on each of its meshes on the CPU, one
torch thread, and pickles {(name, mesh): result} (tensors as numpy) to OUT
with ``{rank}`` filled in.  Only the test process imports JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch

MESHES = {"1x1": None, "2x2": (2, 2), "1x4": (1, 4)}


def _plain(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _loss(model, params, batch, fn):
    if fn == "cls":
        return model.cls_loss(params, batch)[0]
    return model.lm_loss(params, batch)


def run_case(case, mc):
    from repro_torch import bridge, trees
    from repro_torch.models.transformer import Model
    kind = case["kind"]
    if kind in ("loss", "step", "decode", "peft", "fl"):
        cfg = case["cfg"]
        model = Model(cfg, device="cpu", meshctx=mc, impl=case.get("impl", "auto"))
        params = bridge.params_from_numpy(case["params"], cfg)
        if mc is not None:
            params = model.shard(params)
    if kind == "loss":
        return float(_loss(model, params, _t(case["batch"]), case["fn"]))
    if kind == "step":
        from repro_torch.launch.steps import make_train_step
        step, opt = make_train_step(model, lr=case["lr"])
        new, _, loss = step(params, opt.init(params), _t(case["batch"]))
        return {"loss": float(loss), "params": bridge.to_numpy(model.unshard(new))}
    if kind in ("peft", "fl"):
        from repro_torch.launch.steps import make_fl_round_step, make_peft_step
        from repro_torch.models.peft import is_adapter_path
        loras = [bridge.lora_from_numpy(lo, cfg) for lo in case["loras"]]
        train = {"adapters": trees.select(params, is_adapter_path),
                 "lora": loras[0] if kind == "peft" else trees.stack(loras)}
        step, opt = (make_peft_step(model, case["pc"], lr=case["lr"]) if kind == "peft" else
                     make_fl_round_step(model, case["pc"], len(loras), lr=case["lr"]))
        new, _, loss = step(train, params, opt.init(train), _t(case["batch"]))
        return {"loss": float(loss), "train": bridge.to_numpy(new)}
    if kind == "decode":
        lora = bridge.lora_from_numpy(case["lora"], cfg)
        out = []
        with torch.no_grad():
            logits, cache = model.prefill(params, torch.from_numpy(case["prompt"]),
                                          case["cache_len"], lora=lora,
                                          lora_scale=case["scale"])
            out.append(logits)
            for tok in case["next"]:
                logits, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                                  lora=lora, lora_scale=case["scale"])
                out.append(logits)
        return torch.stack(out)
    if kind == "a2a":
        from repro_torch.models.moe import moe_ffn_a2a
        from repro_torch.models.parallel import LayerTP
        m, e_loc = mc.coord(mc.model_axis), case["cfg"].n_experts // mc.model_size
        leaves = {"x": case["x"], "router": case["router"]}
        leaves.update({n: case[n][m * e_loc:(m + 1) * e_loc] for n in ("wg", "wu", "wd")})
        t = {k: torch.from_numpy(v).requires_grad_() for k, v in leaves.items()}
        y, aux = moe_ffn_a2a(t["x"], {k: t[k] for k in ("router", "wg", "wu", "wd")},
                             case["cfg"], case["act"], tp=LayerTP(mc=mc, moe=True))
        ((y * torch.from_numpy(case["r"])).sum() + aux).backward()
        return {"y": y, "aux": aux, "grads": {k: v.grad for k, v in t.items()}}
    if kind == "sp":
        from repro_torch.models.ssm import mamba_seq_sp
        flat = {k: torch.from_numpy(v).requires_grad_() for k, v in case["p"].items()}
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = mamba_seq_sp(x, trees.unflatten(flat), case["cfg"], case["d_model"], case["eps"],
                         mc)
        (y * torch.from_numpy(case["r"])).sum().backward()
        return {"y": y, "dx": x.grad, "grads": {k: v.grad for k, v in flat.items()}}
    if kind == "cohort":
        from repro_torch.core.arch_round import run_arch_round
        from repro_torch.sharding import ClientMesh
        data = ClientMesh(axis_names=("data",), sizes=(mc.shape["data"],),
                          rank=mc.coord("data"), group=mc.group("data"))
        out = {}
        for name, mesh in (("mesh", mc), ("data", data)):
            res = run_arch_round(case["cfg"], mesh=mesh, init=case["init"])
            out[name] = {"loss_per_round": res["loss_per_round"],
                         "global_lora": bridge.to_numpy(res["global_lora"]),
                         "n_ghosts": res["n_ghosts"]}
        return out
    raise ValueError(kind)


def main(argv):
    cases_file, rank, world, store_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.sharding import MeshCtx
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        meshes = {name: (MeshCtx.single_device() if sizes is None else MeshCtx.create(sizes))
                  for name, sizes in MESHES.items()}
        with open(cases_file, "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, case in cases.items():
            for mname in case["meshes"]:
                if meshes[mname].size == 1 and rank:
                    continue
                results[(name, mname)] = _plain(run_case(case, meshes[mname]))
        tmp = out.format(rank=rank) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(results, f)
        os.replace(tmp, out.format(rank=rank))
    finally:
        dist.destroy_process_group()


def spawn(cases, tmp_path, world=4):
    """Start ``world`` worker processes on ``cases``; → a function that
    waits for them and returns each rank's results."""
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

    def wait(timeout=600):
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

    return wait


if __name__ == "__main__":
    main(sys.argv[1:])
