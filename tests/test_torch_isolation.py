"""The port stands alone: it imports neither JAX nor anything of the JAX
package (nor msgpack or PyYAML on import), it builds nothing on import and
its native libraries only under ``build/``, and its entry points run on
``cuda`` unless asked for ``cpu`` — without a GPU they raise instead of
falling back."""

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import dynamic_asr_eval_tpu_torch
from dynamic_asr_eval_tpu_torch.config import TTAConfig
from dynamic_asr_eval_tpu_torch.device import resolve_device
from dynamic_asr_eval_tpu_torch.evals import run
from dynamic_asr_eval_tpu_torch.evals.common import load_model_and_tokenizer
from dynamic_asr_eval_tpu_torch.models import ConformerConfig, SCConformer
from dynamic_asr_eval_tpu_torch.tta import DynamicEvalEngine

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(dynamic_asr_eval_tpu_torch.__file__).parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dynamic_asr_eval_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml",
                                    "sacrebleu", "dynamic_asr_eval_tpu"))
print(len(names))
print(",".join(bad))
"""


def test_importing_every_module_pulls_in_no_jax_and_no_yaml():
    """Nor flax's serializer: the port reads and writes DAE1 checkpoints
    with its own MessagePack codec."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.strip().split("\n") + [""] * (2 - len(proc.stdout.strip().split("\n")))
    assert int(n_modules) >= 20
    assert bad == "", f"the port pulled in {bad}"


NEW_MODULES = ("lm.transformer_lm", "lm.loader", "evals.tlm_tools", "perf", "optim.adafactor",
               "tta.consistency")
PROTOCOL_CLIS = ("evals.run_in_dataset_eval", "evals.run_cross_dataset_eval",
                 "evals.run_half_concat_eval", "evals.run_whole_concat_eval",
                 "evals.run_within_recording_loo_eval", "evals.run_seq_eval",
                 "evals.run_cross_speaker_gender_tedlium", "evals.eval_for_each_cpt",
                 "evals.run_sweep")
PROTOCOL_MODULES = PROTOCOL_CLIS + ("evals.hpo", "analysis")

_IMPORT_EACH = """
import contextlib, importlib, io, json, os, sys
import numpy, torch  # what every port module imports first
results = {}
for name in sys.argv[1:]:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # a child holding nothing of the port
        os.close(r)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                importlib.import_module("dynamic_asr_eval_tpu_torch." + name)
            res = {"printed": out.getvalue(), "pulled_in": sorted(
                m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml",
                                       "wandb", "matplotlib", "transformers", "sacrebleu",
                                       "dynamic_asr_eval_tpu"))}
        except BaseException as e:
            res = {"error": repr(e)}
        os.write(w, json.dumps(res).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        results[name] = json.loads(f.read() or '{"error": "the child died"}')
    os.waitpid(pid, 0)
print(json.dumps(results))
"""


@pytest.fixture(scope="module")
def imported_alone():
    """Each module of the ``*_MODULES`` lists imported on its own, in a child
    forked from one interpreter that holds only numpy and torch: {module:
    what it printed and which forbidden packages it pulled in}.  One
    interpreter start for all of them instead of one each."""
    modules = (NEW_MODULES + OPTION_MODULES + PROTOCOL_MODULES + UTTERANCE_MODULES
               + ENCDEC_MODULES + TRAIN_FUSION_MODULES + PARALLEL_MODULES)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_EACH, *modules], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", NEW_MODULES)
def test_the_transformer_lm_and_consistency_modules_import_alone(module, imported_alone):
    """Each module of the transformer-LM and consistency slice, imported on
    its own, pulls in no JAX, flax, optax, msgpack or PyYAML."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


OPTION_MODULES = ("models.surgery", "models.nemo_convert", "tta.retokenize", "models.conformer",
                  "models.checkpoint", "tta.runner", "evals.common")


@pytest.mark.parametrize("module", OPTION_MODULES)
def test_the_options_slice_modules_import_alone(module, imported_alone):
    """Each module the options slice added or extended (NeMo conversion,
    surgery, re-tokenisation, batch renorm and rel_pos, the engine's options,
    ``--profile``), imported on its own, pulls in no JAX, no module of the
    JAX package, and no PyYAML, wandb or matplotlib."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


@pytest.mark.parametrize("module", PROTOCOL_MODULES)
def test_the_protocol_modules_import_alone(module, imported_alone):
    """Each module of the protocol slice (drivers, sweep, TPE, analysis),
    imported on its own, pulls in no JAX, no module of the JAX package, and
    no PyYAML, wandb or matplotlib: those are imported inside the functions
    that use them."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


UTTERANCE_MODULES = ("tta.utterance", "evals.run_utterance_eval", "augment.waveform",
                     "models.wav2vec2", "evals.run_wav2vec2")


@pytest.mark.parametrize("module", UTTERANCE_MODULES)
def test_the_utterance_and_wav2vec2_modules_import_alone(module, imported_alone):
    """Each module of the utterance and wav2vec2 slice, imported on its own,
    pulls in no JAX, flax, optax, no module of the JAX package, and no
    ``transformers`` (the HF layout is read by name, not through HF)."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


ENCDEC_CLIS = ("evals.enc_dec_inference_test", "evals.enc_dec_ctc_beam_inference_test",
               "evals.enc_dec_dynamic_eval_test")
# models.checkpoint and evals.run_sweep, which gained the enc-dec loaders and
# run scripts, are imported alone by the options and protocol cases above
ENCDEC_MODULES = ENCDEC_CLIS + ("models.encdec", "models.convert", "tta.encdec_rl",
                                "tta.filters", "text.bleu")


@pytest.mark.parametrize("module", ENCDEC_MODULES)
def test_the_encoder_decoder_modules_import_alone(module, imported_alone):
    """Each module of the encoder-decoder slice, imported on its own, pulls in
    no JAX, flax, optax, no module of the JAX package, and no ``sacrebleu``
    (the rewards' BLEU is the port's own ``text/bleu.py``; the card has no
    sacrebleu)."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


_IMPORT_BUILDS_NOTHING = """
import importlib, pkgutil, subprocess
calls = []
run = subprocess.run
subprocess.run = lambda *a, **k: calls.append(a) or run(*a, **k)
import dynamic_asr_eval_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
    importlib.import_module(m.name)
from dynamic_asr_eval_tpu_torch.lm import arpa_native
from dynamic_asr_eval_tpu_torch.text import wer
print(len(calls), arpa_native.LIBRARY._lib is None and wer.LIBRARY._lib is None)
"""


def test_importing_every_module_builds_nothing():
    """The native libraries (``g++``) and the CUDA kernels (``nvcc``) are
    built at first use, never on import."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_BUILDS_NOTHING], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "True"]


def test_native_libraries_build_from_native_sources_into_build():
    """The port reads ``native/*.cc`` as they are and writes its libraries
    under the gitignored ``build/native/``, never into ``native/``."""
    from dynamic_asr_eval_tpu_torch import nativelib
    from dynamic_asr_eval_tpu_torch.lm import arpa_native
    from dynamic_asr_eval_tpu_torch.text import wer

    assert nativelib.BUILD_DIR == REPO / "build" / "native"
    for lib in (arpa_native.LIBRARY, wer.LIBRARY):
        assert lib.source.parent == REPO / "native" and lib.source.exists()
        assert lib.build_dir == nativelib.BUILD_DIR
    assert arpa_native.LIBRARY.libs == ("z",)


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|sacrebleu|dynamic_asr_eval_tpu)(\.|\s|$)",
    re.M)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "multicard_check.py"])
def test_no_source_line_imports_jax_or_the_jax_package(path):
    """Lazy imports inside functions included; nor ``sacrebleu``, which the
    card lacks."""
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.search(src), _FORBIDDEN.search(src).group(0)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_loader_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_and_tokenizer(argparse.Namespace(seed=0))


def test_engine_without_device_raises_without_cuda(no_cuda):
    cfg = ConformerConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16,
                          vocab_size=10, subsampling_conv_channels=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamicEvalEngine(SCConformer(cfg), cfg.blank_id, 8, TTAConfig())


def test_driver_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.cli(["-d", "synthetic", "--quiet"])


def test_lm_without_device_raises_without_cuda(no_cuda, tmp_path):
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter
    from dynamic_asr_eval_tpu_torch.text import CharTokenizer

    path = tmp_path / "lm.arpa"
    path.write_text("\\data\\\nngram 1=1\n\n\\1-grams:\n-1.0\ta\n\n\\end\\\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_lm_adapter(str(path), CharTokenizer())
    assert load_lm_adapter(str(path), CharTokenizer(), device="cpu").device.type == "cpu"


def test_transformer_lm_adapter_without_device_raises_without_cuda(no_cuda, tmp_path):
    from dynamic_asr_eval_tpu_torch.lm.loader import load_lm_adapter, save_lm_checkpoint
    from dynamic_asr_eval_tpu_torch.lm.transformer_lm import TransformerLMConfig, init_lm
    from dynamic_asr_eval_tpu_torch.text import CharTokenizer

    cfg = TransformerLMConfig(vocab_size=28, n_layers=1, d_model=16, n_heads=2)
    path = str(tmp_path / "lm.dlm")
    save_lm_checkpoint(path, init_lm(cfg), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_lm_adapter(path, CharTokenizer())
    assert load_lm_adapter(path, CharTokenizer(), device="cpu").device.type == "cpu"


def test_consistency_engine_without_device_raises_without_cuda(no_cuda):
    from dynamic_asr_eval_tpu_torch.tta import ConsistencyEngine

    cfg = ConformerConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16,
                          vocab_size=10, subsampling_conv_channels=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConsistencyEngine(SCConformer(cfg), cfg.blank_id, 8, TTAConfig())


def test_tlm_tools_without_device_raise_without_cuda(no_cuda, tmp_path):
    from dynamic_asr_eval_tpu_torch.evals import tlm_tools

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm_tools._cli(["dump", "-d", "synthetic", "-s", str(tmp_path)])


@pytest.mark.parametrize("module", PROTOCOL_CLIS)
def test_protocol_clis_without_device_raise_without_cuda(module, no_cuda, tmp_path):
    """Every protocol CLI, the per-checkpoint loop and the sweep raise with
    no GPU and no ``--device cpu``, before any work; with ``--device cpu``
    they run (their parity tests: tests/test_torch_protocols*.py,
    tests/test_torch_sweep.py)."""
    import importlib

    argv = ["-d", "synthetic", "--quiet"]
    if module.endswith("run_cross_dataset_eval"):
        argv = ["-da", "synthetic", "-db", "synthetic", "--quiet"]
    elif module.endswith("eval_for_each_cpt"):
        cfg = ConformerConfig(feat_in=80, n_layers=1, d_model=32, n_heads=2, head_dim=16,
                              vocab_size=28, subsampling_conv_channels=4,
                              compute_dtype="float32")
        torch.save({"model": SCConformer(cfg).state_dict()}, str(tmp_path / "a.pt"))
        argv += ["-cf", str(tmp_path)]
    elif module.endswith("run_sweep"):
        (tmp_path / "s.yaml").write_text(
            "method: grid\nparameters:\n  optim_lr: {values: [1.0e-4]}\n")
        argv += ["-sc", str(tmp_path / "s.yaml"), "--no_wandb"]
    driver = importlib.import_module("dynamic_asr_eval_tpu_torch." + module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.cli(argv)


def test_utterance_engine_without_device_raises_without_cuda(no_cuda):
    from dynamic_asr_eval_tpu_torch.tta import UtteranceTTAEngine

    cfg = ConformerConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16,
                          vocab_size=10, subsampling_conv_channels=4, compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UtteranceTTAEngine(SCConformer(cfg), cfg.blank_id, 8, TTAConfig())


@pytest.mark.parametrize("module,flags", [
    ("evals.run_utterance_eval", []),
    ("evals.run_wav2vec2", []),
    ("evals.run_wav2vec2", ["--per_utterance"]),
], ids=["run_utterance_eval", "run_wav2vec2", "run_wav2vec2 --per_utterance"])
def test_utterance_and_wav2vec2_clis_without_device_raise_without_cuda(module, flags, no_cuda):
    """With ``--device cpu`` they run (tests/test_torch_utterance_drivers.py)."""
    import importlib

    driver = importlib.import_module("dynamic_asr_eval_tpu_torch." + module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.cli(["-d", "synthetic", "--quiet"] + flags)


@pytest.mark.parametrize("module", ENCDEC_CLIS)
def test_encoder_decoder_clis_without_device_raise_without_cuda(module, no_cuda):
    """With ``--device cpu`` they run (tests/test_torch_encdec_drivers.py)."""
    import importlib

    driver = importlib.import_module("dynamic_asr_eval_tpu_torch." + module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.cli(["-d", "synthetic", "--quiet"])


def test_encoder_decoder_engine_without_device_raises_without_cuda(no_cuda):
    from dynamic_asr_eval_tpu_torch.models.encdec import EncDecConfig, EncDecConformer
    from dynamic_asr_eval_tpu_torch.tta.encdec_rl import EncDecDynamicEvalEngine

    cfg = EncDecConfig(encoder=ConformerConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2,
                                               head_dim=16, vocab_size=10,
                                               subsampling_conv_channels=4,
                                               compute_dtype="float32"),
                       decoder_layers=1, decoder_d_model=32, decoder_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EncDecDynamicEvalEngine(EncDecConformer(cfg), cfg, TTAConfig())


F32_DRIVER_MODEL = ConformerConfig(feat_in=80, n_layers=2, d_model=64, n_heads=2, head_dim=32,
                                   vocab_size=28, subsampling_factor=4,
                                   subsampling_conv_channels=8, conv_kernel_size=5,
                                   compute_dtype="float32")


@pytest.mark.parametrize("flags", [["--dp", "--tp", "2"], ["--dp"], ["--dp_records"]],
                         ids=["--dp --tp", "--dp", "--dp_records"])
def test_driver_rejects_what_is_not_ported(flags):
    """``--dp`` and ``--dp_records`` (a world of 1 here) give the serial
    driver's WER on an f32 model (their 2-rank runs against JAX:
    tests/test_torch_parallel.py).  Tensor parallelism is ported
    (tests/test_torch_tensor_parallel.py): at a world of 1, ``--dp --tp 2``
    is refused as JAX's ``make_mesh`` refuses it, 1 device not divisible by
    tp 2."""
    argv = ["-d", "synthetic", "--quiet", "--device", "cpu"]
    if "--tp" in flags:
        with pytest.raises(ValueError, match="not divisible by tp"):
            run.cli(argv + flags)
        return
    assert run.cli(argv + flags, model_config=F32_DRIVER_MODEL) == run.cli(
        argv, model_config=F32_DRIVER_MODEL)


PARALLEL_MODULES = ("parallel", "parallel.mesh", "parallel.collectives")


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_the_data_parallel_modules_import_alone(module, imported_alone):
    """The ``torch.distributed`` slice, imported on its own, pulls in no
    JAX, flax, optax and no module of the JAX package."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


_RUN_SMOKE = """
import runpy, sys, torch
torch.cuda.is_available = lambda: {cuda}
runpy.run_path(sys.argv[1], run_name="__main__")
"""


@pytest.mark.parametrize("where,cuda", [("checkout", False), ("alone", True)])
def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(where, cuda, tmp_path):
    """No card, or ``chip_smoke.py`` in a directory with nothing else of the
    repository: a non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        shutil.copy(REPO / "chip_smoke.py", script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _RUN_SMOKE.format(cuda=cuda), str(script)],
                          cwd=script.parent, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert ("CUDA is not available" if not cuda else "checkout of the repository") in proc.stderr


# the package's __init__ imports nst, data and schedule
TRAIN_FUSION_MODULES = ("train", "train.cli", "lm.word_fusion", "ops.lexicon",
                        "ops.pyctc_compat")


@pytest.mark.parametrize("module", TRAIN_FUSION_MODULES)
def test_the_trainer_and_word_fusion_modules_import_alone(module, imported_alone):
    """Each module of the NST-trainer and word-fusion slice, imported on its
    own, pulls in no JAX, flax, optax, no module of the JAX package, and no
    PyYAML or wandb (the CLI reads a JSON-form yaml without PyYAML)."""
    assert imported_alone[module] == {"printed": "", "pulled_in": []}


def test_train_cli_without_device_raises_without_cuda(no_cuda, tmp_path):
    """With ``--device cpu`` it runs (tests/test_torch_train_cli.py)."""
    from dynamic_asr_eval_tpu_torch.train import cli

    path = tmp_path / "c.yaml"
    path.write_text('{"model": {"feat_in": 16, "n_layers": 1, "d_model": 32}}')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-config", str(path)])


def test_trainer_and_decoders_without_device_raise_without_cuda(no_cuda, tmp_path):
    import numpy as np

    from dynamic_asr_eval_tpu_torch.lm.ngram import load_word_arpa
    from dynamic_asr_eval_tpu_torch.ops.lexicon import word_beam_search
    from dynamic_asr_eval_tpu_torch.ops.pyctc_compat import build_ctcdecoder
    from dynamic_asr_eval_tpu_torch.text import CharTokenizer
    from dynamic_asr_eval_tpu_torch.train import EvalRunner, NSTTrainer, TrainConfig

    cfg = ConformerConfig(feat_in=16, n_layers=1, d_model=32, n_heads=2, head_dim=16,
                          vocab_size=10, subsampling_conv_channels=4, compute_dtype="float32")
    path = tmp_path / "w.arpa"
    path.write_text("\\data\\\nngram 1=1\n\n\\1-grams:\n-1.0\tword\n\n\\end\\\n")
    tok = CharTokenizer()
    calls = [lambda: NSTTrainer(SCConformer(cfg), None, cfg, TrainConfig()),
             lambda: EvalRunner(SCConformer(cfg), cfg, [], tok),
             lambda: load_word_arpa(str(path)),
             lambda: build_ctcdecoder(tok),
             lambda: build_ctcdecoder(tok, str(path)),
             lambda: word_beam_search(np.zeros((4, 29), np.float32), ["word"], tok)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
