"""What the ranks of ``tests/test_torch_parallel.py`` run: port code only
(no JAX; a spawned rank imports this module by name).  Not collected.

``all_ranks(rank_checks, spec)`` joins a gloo group of the launcher's world
on the CPU and runs, one after another in that group, the data-parallel
checks that the test file compares with JAX or with one process: the
pretraining trainer in both modes, identical batches on both ranks, the
semseg trainer with the CRF filter and ``iter_size=2``, a sparse VoteNet
step and the checkpoint names under DDP.  Each returns numpy arrays and floats."""
import torch

from pointcontrast_tpu_torch.nn.res16unet import Res16UNetBase
from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock

THREADS = 2  # as tests/torch_threads.py sets them


class TinyUNet(Res16UNetBase):
    """JAX ``tests/test_parallel.py``'s ``TinyUNet`` shape."""

    BLOCK = BasicBlock
    LAYERS = (1,) * 8
    PLANES = (4, 8, 16, 32, 32, 16, 8, 8)
    INIT_DIM = 4


def params_of(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def buffers_of(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.named_buffers()}


def _pretrain(s: dict, rank: int) -> dict:
    from pointcontrast_tpu_torch.train import PretrainConfig, PretrainTrainer

    model = TinyUNet(in_channels=3, out_channels=8, normalize_feature=True)
    model.load_state_dict(s["state"])
    cfg = PretrainConfig(**s["config"], stat_freq=1, save_freq=10 ** 9,
                         checkpoint_dir=s["dir"])
    batches = s["batches"][rank]
    trainer = PretrainTrainer(model, batches, cfg, "cpu")
    history = trainer.train(len(batches))
    return {"history": [m for _, m in history], "params": params_of(trainer.model),
            "buffers": buffers_of(trainer.model), "net": type(trainer.net).__name__}


def _semseg(s: dict, rank: int) -> dict:
    from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer

    model = s["model"]
    trainer = SemsegTrainer(model, iter(s["batches"][rank]), None,
                            SemsegConfig(**s["config"], checkpoint_dir=s["dir"]),
                            num_classes=s["classes"], device="cpu", crf=s["crf"])
    draws, step = [], trainer._step

    def recording(net, opt, sched, subs, apply_filter):
        draws.append(apply_filter)
        return step(net, opt, sched, subs, apply_filter)

    trainer._step = recording
    history = trainer.train(s["steps"])
    return {"params": params_of(trainer.model), "draws": draws,
            "loss": [m["loss"] for _, m in history]}


def _votenet(s: dict, rank: int) -> dict:
    from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer

    trainer = DetectTrainer(s["model"], s["dc"], DetectConfig(checkpoint_dir=s["dir"]),
                            "cpu")
    loss = trainer.train_epoch(iter([s["batches"][rank]]), 1)
    return {"params": params_of(trainer.model), "loss": loss}


def _checkpoint_names(s: dict, rank: int) -> dict:
    from pointcontrast_tpu_torch.parallel.mesh import data_parallel, unwrap
    from pointcontrast_tpu_torch.tools.from_jax import load_jax_params
    from pointcontrast_tpu_torch.train.checkpoint import load_module_state_dict

    wrapped = data_parallel(TinyUNet(in_channels=3, out_channels=8,
                                     normalize_feature=True))
    load_jax_params(wrapped, s["jax_params"], s["jax_stats"])
    saved = unwrap(wrapped).state_dict()  # what the trainers save
    plain = TinyUNet(in_channels=3, out_channels=8, normalize_feature=True)
    load_module_state_dict(plain, wrapped.state_dict())  # names under module.
    load_module_state_dict(wrapped, plain.state_dict())
    return {"saved_names": sorted(saved), "wrapped_names": sorted(wrapped.state_dict()),
            "reloaded": {k: v.numpy() for k, v in plain.state_dict().items()}}


def all_ranks(fn, *args):
    """``fn(*args)`` in every rank, gathered on rank 0 (each rank's result
    pickled over the gloo group): rank 0 returns them in rank order."""
    import torch.distributed as dist

    from pointcontrast_tpu_torch.parallel import multihost

    torch.set_num_threads(THREADS)
    multihost.initialize("cpu")
    try:
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, fn(*args))
        return got
    finally:
        multihost.shutdown()


def rank_checks(spec: dict) -> dict:
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {name: _pretrain(spec[name], rank) for name in ("nce", "hardest", "same")}
    out["semseg"] = _semseg(spec["semseg"], rank)
    out["votenet"] = _votenet(spec["votenet"], rank)
    out["names"] = _checkpoint_names(spec["names"], rank)
    return {"rank": rank, **out}


def fail_on(rank_to_fail: int):
    """A rank that raises, and one that waits for it in a collective."""
    import torch.distributed as dist

    from pointcontrast_tpu_torch.parallel import multihost

    rank, _, _ = multihost.initialize("cpu")
    if rank == rank_to_fail:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
