"""The benchmark's weights, configuration and plain reference against the
port on the CPU at tiny sizes: the same parameter tree, the same
configuration as the port's own builder makes, and the same logits, losses,
gradients and updates."""
import dataclasses
import importlib.util
import json
import math

import pytest
import torch

from portbench import manifest, tiny, traffic, weights
from portbench.families.transformer import layout, port, reference

CONFIGS = {c["name"]: json.loads((manifest.ROOT / c["file"]).read_text())
           for c in manifest.benchmark()["configs"]}


# routed experts on the dense cell's tiny configuration: the family's MoE
# path, which no cell runs yet, held to the port as the dense one is
MOE = {"n_routed_experts": 8, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "n_shared_experts": 1,
       "first_k_dense_replace": 1, "capacity_factor": 1.25,
       "aux_loss_alpha": 0.01}


def expected(name):
    """The port's own configuration of the model that the configuration
    ``name`` stands for: ``arch_config()`` of ``expect/<name>.py``, which
    builds it with the port's own builder at the published numbers. A
    configuration brings its own such file; no test names it."""
    path = manifest.HERE / "expect" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.expect." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.arch_config()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_is_the_ports(name):
    cfg = CONFIGS[name]
    mine = manifest.family(cfg["family"]).port.arch_config(cfg)
    want = expected(name)
    assert dataclasses.replace(mine, name=want.name) == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layout_is_the_ports(name):
    from repro_torch.models.transformer import RunConfig, init_params
    cfg = CONFIGS[name]
    fam = manifest.family(cfg["family"])
    meta = init_params(fam.port.arch_config(cfg), torch.Generator(),
                       RunConfig(), device="meta")
    theirs = {k: tuple(v.shape) for k, v in weights.named(meta).items()}
    mine = {"".join(f"/{k}" for k in path): tuple(shape)
            for path, shape, _ in fam.layout.leaves(cfg)}
    assert mine == theirs


def test_weights_repeat_from_the_seed():
    leaves = layout.leaves(tiny.config(CONFIGS["mistral-nemo-12b"]))
    a = weights.named(weights.make(leaves, torch.float32, 2**40 + 3, "cpu"))
    b = weights.named(weights.make(leaves, torch.float32, 2**40 + 3, "cpu"))
    c = weights.named(weights.make(leaves, torch.float32, 2**40 + 4, "cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["/embed"], c["/embed"])
    assert float(a["/embed"].std()) == pytest.approx(0.02, rel=0.05)
    scale = a["/final_norm/scale"]  # 1 + normal(0, 0.02): not all ones
    assert float((scale - 1).abs().max()) > 0.01
    assert float(scale.mean()) == pytest.approx(1.0, abs=0.02)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_serve_logits_match_the_port(norm):
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    cfg = tiny.config(CONFIGS["mistral-nemo-12b"], "float32")
    if norm == "layernorm":  # the family's other norm, scale and bias
        cfg = dict(cfg, norm="layernorm", layer_norm_eps=1e-5)
    params = weights.make(layout.leaves(cfg), torch.float32, 5, "cpu")
    model = Model(port.arch_config(cfg), serve.run_config(torch.float32),
                  device="cpu")
    tr = {"sessions": 3, "prompt_len": 12}
    prompts = traffic.prompts(tr, cfg["vocab_size"], 5, 0, "cpu")
    caches = model.init_cache(3, 12 + 6)
    logits, caches = model.prefill(params, prompts, caches)
    got, toks = [logits], [logits.argmax(-1)]
    for i in range(1, 6):
        logits, caches = model.decode_step(params, toks[-1][:, None],
                                           12 + i - 1, caches)
        got.append(logits)
        toks.append(logits.argmax(-1))
    seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
    ref = reference.serve_logits(cfg, params, seq, 11)
    torch.testing.assert_close(torch.stack(got, 1), ref, rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("mlp", ["dense", "moe"])
def test_train_steps_match_the_port(mlp):
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    cell = tiny.cell("mistral-nemo-12b-l5.train")
    cfg, tr = cell.config, cell.traffic
    if mlp == "moe":
        cfg = tiny.config(dict(cfg, **MOE))
    params = weights.make(layout.leaves(cfg), torch.float32, 9, "cpu")
    opt_cfg = AdamWConfig()
    opt = adamw_init(params)
    step = train.make_train_step(port.arch_config(cfg), train.RUN_CONFIG,
                                 opt_cfg)
    batches = [traffic.batch(tr, cfg["vocab_size"], 9, t, "cpu")
               for t in (1, 2, 3)]
    losses = []
    with train.deterministic():
        for t, b in enumerate(batches, 1):
            params, opt, out = step(params, opt, b)
            losses.append(out["loss"].item())
            if t == 1:
                first = {n: float(m.norm()) / (1 - opt_cfg.b1)
                         for n, m in weights.named(opt["m"]).items()}
    ref = weights.named(weights.make(layout.leaves(cfg), torch.float32, 9,
                                     "cpu"))
    start = {n: t.clone() for n, t in ref.items()}
    r_losses, r_first = reference.train(
        cfg, ref, batches, dict(lr=opt_cfg.lr, b1=opt_cfg.b1, b2=opt_cfg.b2,
                                eps=opt_cfg.eps,
                                weight_decay=opt_cfg.weight_decay,
                                grad_clip=opt_cfg.grad_clip,
                                warmup_steps=opt_cfg.warmup_steps))
    assert losses == pytest.approx(r_losses, rel=1e-6)
    assert first == pytest.approx(r_first, rel=1e-5)
    for n, p in weights.named(params).items():
        moved, r_moved = (p.detach() - start[n]).norm(), \
            (ref[n] - start[n]).norm()
        assert math.isclose(moved, r_moved, rel_tol=1e-4), n
