"""Cases that the ranks of the sharded tests run, in processes spawned by
`tests/test_torch_sharded_matmul.py` and `tests/test_torch_sharded_train.py`
(a spawned process imports this module, which imports no JAX)."""
import os
import socket

import numpy as np
import torch

from repro_torch.core.numerics import TRUNCATED_SPECS, DotEngine

FULL_WIDTHS = (8, 16, 24, 32)
ALL_CASES = [(n, None) for n in FULL_WIDTHS] + list(TRUNCATED_SPECS)
PARTS = ("m", "n", "k")
ROW_SIZE = 64        # results/baseline/BENCH_olm_matmul_distributed.json's
SWEEP_SIZE = 32      # tests/test_distributed_matmul.py's


def label(n, p):
    return f"olm{n}" if p is None else f"olm{n}t{p}"


def row_operands():
    # benchmarks/distributed_worker.py's inputs
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ROW_SIZE, ROW_SIZE)).astype(np.float32)
    w = rng.standard_normal((ROW_SIZE, ROW_SIZE)).astype(np.float32)
    return x, w


def sweep_operands():
    rng = np.random.default_rng(0xD15C)
    x = rng.standard_normal((SWEEP_SIZE, SWEEP_SIZE)).astype(np.float32)
    w = rng.standard_normal((SWEEP_SIZE, SWEEP_SIZE)).astype(np.float32)
    return x, w


def lead_operands():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 32)).astype(np.float32)
    return x, w


def matmul_rank(rank, world, port, out_dir):
    """One rank: every sharded case, its outputs saved to out_dir."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (gather_dims,
                                                     gather_dtensor,
                                                     shard_dims)
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.kernels.online_dot.matmul_sharded import (
        olm_matmul_sharded)
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out, errors = {}, {}
    try:
        mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=(
            "model",))
        for tag, (x, w) in (("row", row_operands()),
                            ("sweep", sweep_operands())):
            x, w = torch.from_numpy(x), torch.from_numpy(w)
            for n, p in ALL_CASES:
                for part in PARTS:
                    out[f"{tag}/{label(n, p)}/{part}"] = olm_matmul_sharded(
                        x, w, mesh=mesh, partition=part, n_bits=n, trunc=p)
        x, w = (torch.from_numpy(a) for a in sweep_operands())
        for part in ("m", "n"):
            out[f"auto/{part}"] = olm_matmul_sharded(
                x, w, mesh=mesh, partition=part, n_bits=16, tiling="auto")
        for name, call in (
                ("divisibility", lambda: olm_matmul_sharded(
                    torch.ones(12, 16), torch.ones(16, 16), mesh=mesh,
                    partition="m", n_bits=16)),
                ("unknown_axis", lambda: olm_matmul_sharded(
                    x, w, mesh=mesh, partition="m", axis="nope",
                    n_bits=16))):
            try:
                call()
            except ValueError as e:
                errors[name] = str(e)
        # DotEngine(mesh=, shard=) dispatch
        for part in ("m", "n"):
            out[f"engine/{part}"] = DotEngine(
                mode="olm16", mesh=mesh, shard=part).dot(x, w)
        out["engine/k/olm32t16"] = DotEngine(
            mode="olm32t16", mesh=mesh, shard="k").dot(x, w)
        out["engine/auto/n"] = DotEngine(
            mode="olm16", mesh=mesh, shard="n", tiling="auto").dot(x, w)
        out["engine/inert"] = DotEngine(mode="olm16", mesh=mesh).dot(x, w)
        x3, w3 = (torch.from_numpy(a) for a in lead_operands())
        out["engine/lead3d"] = DotEngine(
            mode="olm16", mesh=mesh, shard="m").dot(x3, w3)
        # the collectives on a 2 x 4 mesh: a dim over both axes, a dim
        # over one, DTensor's chunks and the gathers
        mesh2 = make_local_mesh(2, 4, device_type="cpu")
        sharder = Sharder(mesh2, smoke_config("internlm2_1_8b"))
        full = torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)
        for name, spec in (("both", (("data", "model"), None)),
                           ("split", ("data", "model")),
                           ("model", (None, "model"))):
            pl = sharder.placements(spec)
            mine = shard_dims(full, spec, mesh2)
            dt = distribute_tensor(full, mesh2, pl, src_data_rank=None)
            out[f"coll/{name}/chunk"] = torch.tensor(
                torch.equal(mine, dt.to_local()))
            out[f"coll/{name}/gather"] = torch.tensor(
                torch.equal(gather_dims(mine, spec, mesh2), full))
            out[f"coll/{name}/dtensor"] = torch.tensor(
                torch.equal(gather_dtensor(dt), full))
    finally:
        torch.save({"out": out, "errors": errors},
                   os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]




# ---------------------------------------------------------------- training
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 16
CLI_ARGS = ["--arch", "internlm2_1_8b", "--smoke", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--steps", "3", "--log-every", "1",
            "--ckpt-every", "100"]


def train_config():
    import dataclasses
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config("internlm2_1_8b"), n_layers=2)


def train_batches(cfg, n=TRAIN_STEPS):
    from repro_torch.data.synthetic import SyntheticLMDataset
    data = SyntheticLMDataset(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    return [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(n)]


def run_steps(step, state, batches):
    """(the state after the steps, each step's loss and grad_norm as
    (steps, 2) f32)."""
    seen = []
    for b in batches:
        state, met = step(state, b)
        seen.append(torch.stack([met["loss"], met["grad_norm"]]))
    return state, torch.stack(seen)


def train_rank(rank, world, port, out_dir):
    """One rank: the sharded train step on the (1, 2) and (2, 1) meshes, a
    checkpoint saved on (2, 1) and restored on (1, 2), an olm16 step with
    shard="n", and the train CLI over the two ranks."""
    import contextlib
    import io

    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.numerics import EngineSpec
    from repro_torch.distributed.sharding import Sharder
    from repro_torch.distributed.train import (build_train_step,
                                               distribute_state,
                                               gather_state,
                                               init_train_state,
                                               state_shardings,
                                               train_state_specs)
    from repro_torch.kernels.online_dot import matmul_sharded
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    from torch.distributed.tensor import DTensor
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    cfg = train_config()
    model = Model(cfg, device="cpu")
    batches = train_batches(cfg)
    out = {}
    try:
        meshes = {s: make_local_mesh(*s, device_type="cpu")
                  for s in ((1, 2), (2, 1))}
        sharders = {}
        for shape, mesh in meshes.items():
            sharders[shape] = sharder = Sharder(mesh, cfg)
            sharder.set_batch(TRAIN_BATCH)
            state = distribute_state(sharder, init_train_state(model, 0))
            out[f"{shape}/at_rest"] = torch.tensor(all(
                isinstance(t, DTensor) for t in tree_leaves(state)))
            out[f"{shape}/local_numel"] = torch.tensor(sum(
                t.to_local().numel() for t in tree_leaves(state["params"])))
            state, seen = run_steps(build_train_step(model, sharder),
                                    state, batches)
            out[f"{shape}/params"] = tree_leaves(gather_state(
                state["params"]))
            out[f"{shape}/metrics"] = seen
            if shape == (2, 1):
                saved = state
                specs = train_state_specs(sharder, state)
                out["specs/keys"] = repr((sorted(specs), sorted(
                    specs["opt"]), specs["opt"]["step"], specs["ef"]))
        # saved on (2, 1), restored onto (1, 2): the same bits (rank 0
        # writes in the background; restore waits for it on every rank)
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
        ckpt.save(TRAIN_STEPS, saved)
        like = distribute_state(sharders[(1, 2)],
                                init_train_state(model, 1))
        restored = ckpt.restore(like, shardings=state_shardings(
            sharders[(1, 2)], like))
        out["restore/placements"] = repr(
            tree_leaves(restored["params"])[0].placements)
        out["restore/same"] = torch.tensor(all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(gather_state(restored)),
                tree_leaves(gather_state(saved)))))
        # the params alone, as a subtree of the train state
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt_params"))
        ckpt.save(TRAIN_STEPS, {"params": saved["params"]})
        like = {"params": like["params"]}
        restored = ckpt.restore(like, shardings=state_shardings(
            sharders[(1, 2)], like))
        out["restore/params_same"] = torch.tensor(all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(gather_state(restored)),
                tree_leaves(gather_state(saved["params"])))))
        # compressed gradients on (1, 2)
        state, _ = run_steps(build_train_step(
            model, sharders[(1, 2)], compress_grads=True),
            distribute_state(sharders[(1, 2)], init_train_state(model, 0)),
            batches[:2])
        out["compress/params"] = tree_leaves(gather_state(state["params"]))
        out["compress/ef"] = tree_leaves(gather_state(state["ef"]))
        # one olm16 step with every GEMM sharded over n on (1, 2)
        calls = []
        real = matmul_sharded.olm_matmul_sharded

        def counted(*a, **kw):
            calls.append(kw["partition"])
            return real(*a, **kw)

        matmul_sharded.olm_matmul_sharded = counted
        try:
            step = build_train_step(model, sharders[(1, 2)],
                                    engine_spec=EngineSpec(mode="olm16",
                                                           shard="n"))
            state, met = step(distribute_state(
                sharders[(1, 2)], init_train_state(model, 0)),
                {k: v[:1, :8] for k, v in batches[0].items()})
        finally:
            matmul_sharded.olm_matmul_sharded = real
        out["olm16/calls"] = repr(calls)
        out["olm16/grad_norm"] = met["grad_norm"]
        out["olm16/params"] = tree_leaves(gather_state(state["params"]))
        # the train CLI over the two ranks: a (2, 1) mesh, --dot-shard n
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = train_cli.main([*CLI_ARGS, "--dot-shard", "n",
                                      "--ckpt-dir",
                                      os.path.join(out_dir, "cli")])
        out["cli/summary"] = repr(summary)
        out["cli/stdout"] = buf.getvalue()
    finally:
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# ------------------------------------------------------ partitioned serve
# tests/test_torch_tp_serve.py: one gloo group of 4 ranks on a (data 2,
# model 2) mesh; each case a smoke-size config at f32 compute, 2 layers.
# The kv heads divide `model` in "heads", "fsdp_bias", "moe_ep" and
# "moe_tp_ring" (cache over heads), not in the others (cache over
# length); 3 query heads over 2 ranks in "uneven"; `data`-sharded weights
# in the fsdp cases and the MoE ones (fsdp_tp); vocab 500 (padded to 512)
# in "heads" and "moe_ep"; a tied head in "fsdp_length_tied". The MoE
# cases: Qwen3-MoE's 8 smoke experts split over `model` (ep, 4 a rank),
# Mixtral's split by d_ff (tp) with a window of 4, so that the 6-token
# prompt is longer than the ring and the decodes wrap it, the ring over
# kv heads and, with one kv head, over its length (2 slots a rank).
# "hybrid": RecurrentGemma at 4 layers, one (rec, rec, attn) group and a
# "rec" remainder, the RG-LRU over `model` and its one-KV-head ring of 4
# over its length; "ssm": Mamba2, its weights replicated and the batch
# over both axes (1 row a rank). The cross-attention cases, each with
# TP_BATCH rows of frontend embeddings (`tp_frontend`): "vlm",
# Llama-3.2-Vision at 5 layers, its pattern once (4 attn + 1 cross), GQA
# 4/2 by heads under fsdp_tp; "encdec", SeamlessM4T's 2 encoder and 2
# xdec layers by heads; "encdec_uneven", 3 query heads and 1 kv head: the
# decoder's cache over its length, the encoder's and the cross layers'
# heads through `Partition.head_range`.
TP_MESH = (2, 2)
TP_BATCH, TP_PROMPT, TP_LEN, TP_DECODES = 4, 6, 16, 4
TP_COMMON = dict(n_layers=2, compute_dtype="float32")
TP_CASES = {
    "heads": ("internlm2_1_8b", dict(vocab_size=500)),
    "length_bias": ("chatglm3_6b", dict(n_kv_heads=1)),
    "uneven": ("internlm2_1_8b", dict(n_heads=3, n_kv_heads=1)),
    "fsdp_bias": ("qwen1_5_110b", {}),
    "fsdp_length_tied": ("yi_34b", dict(n_kv_heads=1, tie_embeddings=True)),
    "moe_ep": ("qwen3_moe_235b_a22b", dict(vocab_size=500)),
    "moe_tp_ring": ("mixtral_8x22b", dict(sliding_window=4)),
    "moe_tp_ring_length": ("mixtral_8x22b", dict(sliding_window=4,
                                                 n_kv_heads=1)),
    "hybrid": ("recurrentgemma_9b", dict(n_layers=4, sliding_window=4)),
    "ssm": ("mamba2_130m", {}),
    "vlm": ("llama_3_2_vision_11b", dict(n_layers=5)),
    "encdec": ("seamless_m4t_medium", {}),
    "encdec_uneven": ("seamless_m4t_medium", dict(n_heads=3, n_kv_heads=1)),
}
MEMORY_CASES = [n for n, (arch, _) in TP_CASES.items()
                if arch in ("llama_3_2_vision_11b", "seamless_m4t_medium")]
MOE_CASES = [n for n, (arch, _) in TP_CASES.items() if "moe" in arch]
# one prefill of one MOE_DROPS_TOKENS-token row with 2 experts, both of
# them a token, at capacity factor 0.5: capacity 8 of the 12 assignments
# each expert gets, so each drops 4 whatever the router (ep, 1 a rank)
MOE_DROPS = ("qwen3_moe_235b_a22b", dict(n_experts=2, experts_per_token=2,
                                         capacity_factor=0.5))
MOE_DROPS_TOKENS = 12
# one olm16 pass of the "heads" case at one layer: K1 (its plain version
# here) on each rank's shards
TP_OLM_CASE = "heads"
TP_OLM_GEMMS_PER_PASS = 8       # wq wk wv wo wg wu wd, the head


def tp_config(name, smoke=None):
    """The case's config ("moe_drops" too) from `smoke` (the port's
    smoke_config, or the reference's for the test's side)."""
    import dataclasses
    if smoke is None:
        from repro_torch.configs import smoke_config as smoke
    arch, over = MOE_DROPS if name == "moe_drops" else TP_CASES[name]
    return dataclasses.replace(smoke(arch), **{**TP_COMMON, **over})


def moe_drops_tokens():
    """The drops case's one row, (1, MOE_DROPS_TOKENS)."""
    rng = np.random.default_rng(26)
    return rng.integers(0, 512, (1, MOE_DROPS_TOKENS)).astype(np.int32)


class RoutedPlans:
    """The dispatch plan (token per slot, each assignment's slot, its keep
    flag) of every batch row that a `models/moe._route_rows` call made
    inside the block routes, in call and row order, on the CPU
    (tests/test_torch_gpu.py's ranks too)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.plans = moe._route_rows, []

        def recorded(*a, **kw):
            plan = self.real(*a, **kw)
            rows = torch.cat([plan[0], plan[1], plan[4].to(plan[0].dtype)],
                             dim=1).cpu()
            self.plans.extend(rows)
            return plan

        moe._route_rows = recorded
        return self.plans

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route_rows = self.real


def tp_inputs():
    """(prompt tokens (B, S), decode tokens (steps, B), decode positions
    (steps, B)): lanes at their own depths, so a step writes slots on both
    ranks' halves of a length-sharded cache."""
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, 500, (TP_BATCH, TP_PROMPT)).astype(np.int32)
    steps = rng.integers(0, 500, (TP_DECODES, TP_BATCH)).astype(np.int32)
    pos = (TP_PROMPT + np.arange(TP_DECODES)[:, None]
           + np.array([0, 1, 2, 3])[None]).astype(np.int32)
    return prompt, steps, pos


def tp_frontend(cfg):
    """(the batch key, TP_BATCH rows of frontend embeddings (B, M,
    d_model) f32) of a cross-attention case, (None, None) otherwise."""
    from repro_torch.distributed.train import MEMORY_KEYS
    key = MEMORY_KEYS.get(cfg.family)
    if key is None:
        return None, None
    rng = np.random.default_rng(27)
    return key, rng.standard_normal((TP_BATCH, cfg.n_frontend_tokens,
                                     cfg.d_model)).astype(np.float32)


def tp_gemm_operands():
    """(x, w) of a column-parallel and of a row-parallel olm16 GEMM."""
    rng = np.random.default_rng(25)
    col = (rng.standard_normal((6, 64)), rng.standard_normal((64, 96)))
    row = (rng.standard_normal((6, 96)), rng.standard_normal((96, 64)))
    return [tuple(a.astype(np.float32) for a in pair) for pair in (col, row)]


def _nbytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_rank(rank, world, port, out_dir):
    """One rank: every case's partitioned prefill and decodes on the
    reference's params (given.pt, numpy), its blocks' shapes and
    argument bytes, the sharded init against the whole init's blocks, the
    olm16 GEMMs and one olm16 pass; written to rank<r>.pt."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.convert import params_from_jax
    from repro_torch.core.numerics import DotEngine
    from repro_torch.distributed.collectives import shard_dims
    from repro_torch.distributed.partition import Partition
    from repro_torch.distributed.sharding import Sharder, path_leaves
    from repro_torch.distributed.train import (init_serve_cache,
                                               init_serve_params,
                                               jit_decode_step,
                                               jit_prefill_step,
                                               param_blocks, serve_params)
    from repro_torch.kernels.online_dot import matmul
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_local_mesh(*TP_MESH, device_type="cpu")
        given = torch.load(os.path.join(out_dir, "given.pt"),
                           weights_only=False)
        prompt, steps, pos = (torch.from_numpy(a) for a in tp_inputs())

        def serve(model, sharder, params):
            """(the logits of every pass, the cache's block shapes, the
            argument bytes, the dispatch plans, the prefill's memory)"""
            bd = sharder.batch_spec()[0]

            def rows(t):
                return shard_dims(t, (bd,) + (None,) * (t.ndim - 1), mesh)
            cache = init_serve_cache(model, sharder, TP_BATCH, TP_LEN)
            shapes = {p: tuple(t.shape) for p, t in path_leaves(cache)}
            batch = {"tokens": rows(prompt)}
            key, front = tp_frontend(model.cfg)
            if key is not None:
                batch[key] = rows(torch.from_numpy(front))
            with RoutedPlans() as plans:
                logits, cache, memory = jit_prefill_step(
                    model, sharder, params, list(batch), cache)(
                    params, batch, cache)
                seen = [logits]
                extra = () if memory is None else (memory,)
                decode = jit_decode_step(model, sharder, params, cache,
                                         has_memory=bool(extra))
                for tok, p in zip(steps, pos):
                    logits, cache = decode(params, rows(tok), rows(p),
                                           cache, *extra)
                    seen.append(logits)
            args = {"prefill": _nbytes(params) + _nbytes(cache)
                    + _nbytes(batch),
                    "decode": _nbytes(params) + _nbytes(cache)
                    + 2 * _nbytes(rows(steps[0])) + _nbytes(extra)}
            return torch.stack(seen), shapes, args, plans, memory

        for name in TP_CASES:
            cfg = tp_config(name)
            sharder = Sharder(mesh, cfg)
            sharder.set_batch(TP_BATCH)
            model = Model(cfg, device="cpu")
            params = params_from_jax(given[name], cfg, device="cpu",
                                     sharder=sharder)
            out[f"{name}/params"] = {p: tuple(t.shape)
                                     for p, t in path_leaves(params)}
            (out[f"{name}/logits"], out[f"{name}/cache"],
             out[f"{name}/args"], out[f"{name}/plans"],
             out[f"{name}/memory"]) = serve(model, sharder, params)
            mine = init_serve_params(model, sharder, seed=3)
            want = param_blocks(serve_params(model.init(3)), sharder)
            out[f"{name}/init"] = torch.tensor(all(
                a.dtype == b.dtype and torch.equal(a, b)
                for (_, a), (_, b) in zip(path_leaves(mine),
                                          path_leaves(want))))
            if name == "fsdp_bias":
                # the GEMMs alone, weights over `data` too
                part = Partition(sharder)
                eng = DotEngine(mode="olm16")
                (xc, wc), (xr, wr) = (
                    tuple(torch.from_numpy(a) for a in pair)
                    for pair in tp_gemm_operands())
                out["gemm/col"] = part.col(eng, xc, shard_dims(
                    wc, ("data", "model"), mesh))
                out["gemm/row"] = part.row(eng, shard_dims(
                    xr, (None, "model"), mesh), shard_dims(
                    wr, ("model", "data"), mesh))
        # one prefill that drops assignments, the batch of one row whole
        # on every rank
        cfg = tp_config("moe_drops")
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(1)
        model = Model(cfg, device="cpu")
        params = params_from_jax(given["moe_drops"], cfg, device="cpu",
                                 sharder=sharder)
        cache = init_serve_cache(model, sharder, 1, TP_LEN)
        with RoutedPlans() as plans:
            logits, _, _ = jit_prefill_step(
                model, sharder, params, ["tokens"], cache)(
                params, {"tokens": torch.from_numpy(moe_drops_tokens())},
                cache)
        out["moe_drops/logits"] = logits
        out["moe_drops/plans"] = plans
        # one olm16 pass: the GEMMs a rank issues, layer 0's wq
        cfg = dataclasses.replace(tp_config(TP_OLM_CASE), n_layers=1)
        sharder = Sharder(mesh, cfg)
        sharder.set_batch(TP_BATCH)
        model = Model(cfg, DotEngine(mode="olm16"), device="cpu")
        params = params_from_jax(given["olm"], cfg, device="cpu",
                                 sharder=sharder)
        calls = []
        real = matmul.olm_matmul

        def counted(x, w, **kw):
            res = real(x, w, **kw)
            calls.append((x, w, res) if not calls else None)
            return res

        matmul.olm_matmul = counted
        try:
            logits = serve(model, sharder, params)[0]
        finally:
            matmul.olm_matmul = real
        out["olm/calls"] = torch.tensor(len(calls))
        out["olm/wq"] = calls[0]
        out["olm/logits"] = logits
    finally:
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# ------------------------------------------------------ partitioned train
# tests/test_torch_tp_train.py: the partitioned train step
# (`distributed/train.py::jit_train_step`) on the same gloo group of 4
# ranks on (data 2, model 2), TP_TRAIN_STEPS steps of TP_TRAIN_BATCH x
# TP_TRAIN_SEQ a run, on the reference's params. The runs reuse TP_CASES'
# configs by name; "heads" also with 2 microbatches and with compressed
# gradients, "hybrid" (the RG-LRU's gather under checkpoint) also under
# remat "block".
TP_TRAIN_CASES = ("heads", "uneven", "fsdp_length_tied", "moe_ep",
                  "moe_tp_ring", "hybrid", "ssm", "vlm", "encdec")
# run -> (its TP_CASES config, jit_train_step's keywords, config overrides)
TP_TRAIN_RUNS = {
    **{name: (name, {}, {}) for name in TP_TRAIN_CASES},
    "heads_mb2": ("heads", {"microbatches": 2}, {}),
    "heads_compress": ("heads", {"compress_grads": True}, {}),
    "hybrid_remat": ("hybrid", {}, {"remat": "block"}),
}
TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 4, 8, 2
# ids a data rank of `Partition.lookup`'s two routes: 2 x 4 rows gathered,
# 2 x 200 (the two data ranks' 800 ids past the table's 256 rows a model
# rank) the table gathered
LOOKUP_IDS = (4, 200)


def tp_train_config(run, smoke=None):
    """The run's config (`tp_config` of its case, its overrides)."""
    import dataclasses
    case, _, over = TP_TRAIN_RUNS[run]
    return dataclasses.replace(tp_config(case, smoke), **over)


def tp_train_batches(cfg):
    """TP_TRAIN_STEPS whole batches of numpy arrays: tokens (B, S) and, for
    a cross-attention config, its frontend embeddings (B, M, d_model)."""
    from repro_torch.distributed.train import MEMORY_KEYS
    rng = np.random.default_rng(28)
    out = []
    for _ in range(TP_TRAIN_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (
            TP_TRAIN_BATCH, TP_TRAIN_SEQ)).astype(np.int32)}
        key = MEMORY_KEYS.get(cfg.family)
        if key is not None:
            b[key] = rng.standard_normal((TP_TRAIN_BATCH,
                                          cfg.n_frontend_tokens,
                                          cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


class LargestMade:
    """The bytes of the largest tensor any op makes inside the block (a
    TorchDispatchMode over the op's outputs)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        box = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    if isinstance(t, torch.Tensor):
                        box.bytes = max(box.bytes,
                                        t.numel() * t.element_size())
                return out

        self.bytes = 0
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _lookup_routes(sharder, mesh):
    """`Partition.lookup` under fsdp_tp by both of its routes, the looked-up
    rows gathered over `data` (LOOKUP_IDS[0] ids a data rank, fewer than
    the table's rows) and the table gathered (LOOKUP_IDS[1]): each
    rank's rows and its block's gradient of sum(rows * weights) against
    the whole table's, every data rank's ids and weights drawn from
    seeds."""
    from repro_torch.distributed.collectives import (axis_coordinate,
                                                     shard_dims)
    from repro_torch.distributed.partition import Partition
    part = Partition(sharder)
    c, n = axis_coordinate(mesh, "data")
    V, d = sharder.cfg.vocab_padded // part.size, sharder.cfg.d_model
    whole = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (V, d)).astype(np.float32))
    out = {}
    for k in LOOKUP_IDS:
        def drawn(r):
            rng = np.random.default_rng(30 + 100 * k + r)
            return (torch.from_numpy(rng.integers(0, V, (2, k))),
                    torch.from_numpy(rng.standard_normal((2, k, d)).astype(
                        np.float32)))
        ids, w = drawn(c)
        block = shard_dims(whole, (None, "data"), mesh).clone()
        block.requires_grad_(True)
        rows = part.lookup(block, ids)
        (grad,) = torch.autograd.grad((rows * w).sum(), block)
        want = torch.zeros_like(whole)
        for r in range(n):
            ids_r, w_r = drawn(r)
            want.index_put_((ids_r.reshape(-1),), w_r.reshape(-1, d),
                            accumulate=True)
        out[f"lookup/{k}"] = torch.tensor(
            torch.equal(rows, whole[ids]) and torch.allclose(
                grad, shard_dims(want, (None, "data"), mesh), rtol=0,
                atol=1e-6))
    return out


def tp_train_rank(rank, world, port, out_dir):
    """One rank: every TP_TRAIN_RUNS run's partitioned steps on the
    reference's params (train_given.pt, numpy), its gradient blocks after
    the first step's sums, the metrics and params after each step, its
    block shapes, argument bytes and the largest tensor a step makes, and
    the sharded init against the whole init's blocks; to
    train_rank<r>.pt."""
    import torch.distributed as dist
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.collectives import shard_dims
    from repro_torch.distributed.sharding import Sharder, path_leaves
    from repro_torch.distributed.train import (_local, distribute_state,
                                               init_train_state,
                                               jit_train_step)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_local_mesh(*TP_MESH, device_type="cpu")
        given = torch.load(os.path.join(out_dir, "train_given.pt"),
                           weights_only=False)
        for run, (case, kw, _) in TP_TRAIN_RUNS.items():
            cfg = tp_train_config(run)
            sharder = Sharder(mesh, cfg)
            sharder.set_batch(TP_TRAIN_BATCH)
            model = Model(cfg, device="cpu")
            whole = params_from_jax(given[case], cfg, device="cpu")
            state = distribute_state(sharder, {
                "params": whole, "opt": adamw_init(whole), "ef": None})
            del whole
            batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                       for b in tp_train_batches(cfg)]
            specs = sharder.batch_specs(list(batches[0]))
            rows = [{k: shard_dims(v, specs[k], mesh) for k, v in b.items()}
                    for b in batches]
            step = jit_train_step(model, sharder, state, list(specs), **kw)
            local = tree_map(_local, state)
            out[f"{run}/shapes"] = {p: tuple(t.shape)
                                    for p, t in path_leaves(local["params"])}
            out[f"{run}/args"] = _nbytes(local) + _nbytes(rows[0])
            _, _, grads = step.grads(state, rows[0])
            out[f"{run}/grads"] = dict(path_leaves(grads))
            seen, largest = [], 0
            for b in rows:
                with LargestMade() as big:
                    state, met = step(state, b)
                largest = max(largest, big.bytes)
                seen.append(torch.stack([met["loss"], met["grad_norm"]]))
            out[f"{run}/metrics"] = torch.stack(seen)
            out[f"{run}/largest"] = largest
            out[f"{run}/params"] = dict(path_leaves(
                tree_map(_local, state["params"])))
            if run == "fsdp_length_tied":
                out.update(_lookup_routes(sharder, mesh))
            if run == case:
                mine = init_train_state(model, seed=3, sharder=sharder)
                want = distribute_state(sharder, init_train_state(model, 3))
                out[f"{run}/init"] = torch.tensor(all(
                    a.dtype == b.dtype and torch.equal(_local(a), _local(b))
                    and a.placements == b.placements
                    for a, b in zip(tree_leaves(mine), tree_leaves(want))))
    finally:
        torch.save(out, os.path.join(out_dir, f"train_rank{rank}.pt"))
        dist.destroy_process_group()
