"""Command-line interface of the port (port of ``pocket_tts_tpu/cli.py``):
``generate``, ``batch``, ``quantize``, ``finetune``, ``serve`` and ``fleet``.

    python -m pocket_tts_tpu_torch.cli generate --text "Hello." -o out.wav
    python -m pocket_tts_tpu_torch.cli batch --manifest lines.txt -o out_dir
    python -m pocket_tts_tpu_torch.cli quantize -o m.int8.safetensors
    python -m pocket_tts_tpu_torch.cli finetune --manifest pairs.jsonl -o m.ft.safetensors
    python -m pocket_tts_tpu_torch.cli serve --device cuda --batch-size 16
    python -m pocket_tts_tpu_torch.cli fleet --workers http://h1:8001,http://h2:8001

``generate --stream`` writes raw s16le PCM to stdout.  ``batch`` synthesizes
a manifest (plain lines, or JSONL ``{"text", "voice"?, "output"?,
"adapter"?}``) concurrently through the continuous batcher, one WAV per
line; ``--adapter NAME=PATH`` registers the LoRA adapters its lines select,
which ride one decode loop as an adapter bank.  ``finetune`` trains the
FlowLM (or, with ``--lora-rank``, a LoRA adapter) on a JSONL manifest of
``{"text", "audio"}`` pairs and writes the artifact that ``--finetuned``
loads on ``generate``, ``batch`` and ``serve`` (either kind; applied before
``--quantized``).  ``serve`` starts the HTTP server (``server/app.py``;
``--batch-size`` > 1 serves concurrent requests through the continuous
batcher; ``--adapter NAME=PATH`` registers request-selectable adapters),
``fleet`` a router over several servers (``server/fleet.py``); both need
``aiohttp``.  ``--quantized`` runs on int8 weights quantized at load;
``quantize`` writes the int8 (or ``--bits 4``) artifact that
``TTSModel.load_quantized`` and the JAX package read.  ``--device``
picks the torch device (default ``cuda``; with no card visible the command
fails unless ``--device cpu`` is given); its name is printed on stderr.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _add_gen_params(p: argparse.ArgumentParser) -> None:
    p.add_argument("--variant", default="b6369a24")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--lsd-decode-steps", type=int, default=1)
    p.add_argument("--eos-threshold", type=float, default=-4.0)
    p.add_argument("--noise-clamp", type=float, default=None)
    p.add_argument("--frames-after-eos", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantized", action="store_true", help="int8 weight quantization")
    p.add_argument("--finetuned", default=None, metavar="PATH",
                   help="load a fine-tuned FlowLM checkpoint or LoRA adapter "
                        "(written by the finetune command; kind auto-detected)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; --device cpu runs on the CPU)")


def _load_model(args):
    from pocket_tts_tpu_torch.tts import TTSModel

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    model = TTSModel.load_with_params(
        args.variant, temp=args.temperature, lsd_decode_steps=args.lsd_decode_steps,
        noise_clamp=args.noise_clamp, eos_threshold=args.eos_threshold,
        seed=args.seed, device=args.device)
    if getattr(args, "finetuned", None):
        from pocket_tts_tpu_torch.training import apply_adapted

        model = apply_adapted(model, args.finetuned)
    if args.quantized:
        from pocket_tts_tpu_torch.runtime.quantize import quantize_model

        model = quantize_model(model)
    return model


def _print_device(model) -> None:
    dev = model.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", file=sys.stderr)


def cmd_generate(args) -> int:
    from pocket_tts_tpu_torch import audio as audio_io
    from pocket_tts_tpu_torch.server import voices as voices_mod

    model = _load_model(args)
    _print_device(model)
    voice = None
    if args.voice:
        try:
            voice = voices_mod.resolve_voice(model, args.voice)
        except Exception as e:  # noqa: BLE001
            print(f"warning: voice {args.voice!r} unresolvable ({e}); "
                  "using unconditioned state", file=sys.stderr)

    fae = args.frames_after_eos
    if args.stream:
        for chunk in model.generate_stream_long(args.text, voice, fae,
                                                continuation_frames=args.continuation):
            sys.stdout.buffer.write(audio_io.pcm_i16_le_bytes(chunk))
            sys.stdout.buffer.flush()
        return 0

    total = model.estimate_generation_steps(args.text)
    t0 = time.time()
    chunks = []
    done_frames = 0
    # a file has no consumer of early chunks: skip the warm-up chunk ramp
    for chunk in model.generate_stream_long(args.text, voice, fae, low_latency=False,
                                            continuation_frames=args.continuation):
        chunks.append(chunk)
        done_frames += len(chunk) // model.frame_size
        if not args.quiet:
            pct = min(100, int(100 * done_frames / max(total, 1)))
            secs = sum(len(c) for c in chunks) / model.sample_rate
            print(f"\r[{pct:3d}%] {secs:.1f}s audio generated", end="",
                  file=sys.stderr, flush=True)
    wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    audio_io.write_wav(args.output, wav, model.sample_rate)
    if not args.quiet:
        dur = wav.size / model.sample_rate
        dt = time.time() - t0
        print(f"\nWrote {args.output}: {dur:.2f}s audio in {dt:.2f}s "
              f"({dur / max(dt, 1e-9):.1f}x realtime)", file=sys.stderr)
    return 0


def _read_manifest(path: str) -> list:
    """Manifest -> [(text, voice spec | None, output name | None, adapter
    name | None)].  Plain lines are bare utterances; lines that start with
    "{" are JSONL; blank lines and "#" comments are skipped.  Raises
    ValueError on a bad entry."""
    items = []
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if not line.startswith("{"):
                items.append((line, None, None, None))
                continue
            try:
                obj = json.loads(line)
                text = obj["text"]
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                raise ValueError(f"{path}:{lineno}: bad JSONL entry ({e!r})") from None
            out_name = obj.get("output")
            if out_name is not None and not isinstance(out_name, str):
                raise ValueError(f"{path}:{lineno}: \"output\" must be a string, got "
                                 f"{type(out_name).__name__}")
            items.append((text, obj.get("voice"), out_name, obj.get("adapter")))
    if not items:
        raise ValueError(f"{path}: no utterances")
    return items


def cmd_batch(args) -> int:
    """Offline batch synthesis: one WAV per manifest line, decoded
    concurrently through the continuous batcher at aggregate throughput."""
    from pocket_tts_tpu_torch import audio as audio_io
    from pocket_tts_tpu_torch.runtime.batcher import batched_tts
    from pocket_tts_tpu_torch.server import voices as voices_mod

    # everything that can be refused is refused before the model loads
    try:
        items = _read_manifest(args.manifest)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir.resolve()
    # --adapter NAME=PATH registers the adapters the manifest's lines select
    reg = _adapter_specs(args.adapter)
    if reg is None:
        return 2
    used = sorted({a for *_, a in items if a is not None})
    bad = sorted(set(used) - set(reg))
    if bad:
        print(f"manifest uses unregistered adapters {bad}; register with "
              f"--adapter name=path", file=sys.stderr)
        return 2
    paths = []
    for i, (_, _, name, _) in enumerate(items):
        p = out_dir / (name or f"{i:05d}.wav")
        # a manifest is data: an absolute or ../-escaping "output" must not
        # write outside --out-dir
        if not p.resolve().is_relative_to(root):
            print(f"manifest output {name!r} escapes --out-dir {out_dir}", file=sys.stderr)
            return 2
        paths.append(p)
    dupes = [p for p, n in collections.Counter(paths).items() if n > 1]
    if dupes:
        print(f"duplicate output paths in manifest: {sorted(str(p) for p in dupes)}",
              file=sys.stderr)
        return 2

    model = _load_model(args)
    _print_device(model)
    bank = None
    adapted: dict[str, object] = {}  # merged models, for voices of adapter lines
    if used:
        from pocket_tts_tpu_torch.training import apply_adapted
        from pocket_tts_tpu_torch.training.lora import build_adapter_bank

        try:
            bank = build_adapter_bank({n: reg[n] for n in used})
        except ValueError as e:
            print(f"adapter bank: {e}", file=sys.stderr)
            return 2
    resolved: dict[tuple, object] = {}
    voices = []
    for _, spec, _, aname in items:
        spec = spec or args.voice
        if spec is None:
            voices.append(None)
            continue
        key = (spec, aname)
        if key not in resolved:  # a voice encode is a prefill: once per spec and adapter
            try:
                # a voice on an adapter line prefills through that adapter's
                # backbone (its merged model, built once per adapter)
                vm = model
                if aname is not None:
                    if aname not in adapted:
                        adapted[aname] = apply_adapted(model, reg[aname])
                    vm = adapted[aname]
                resolved[key] = voices_mod.resolve_voice(vm, spec)
            except Exception as e:  # noqa: BLE001
                # fail before synthesis: a batch silently re-voiced to the
                # default would waste the run
                print(f"voice {spec!r} unresolvable: {e}", file=sys.stderr)
                return 2
        voices.append(resolved[key])

    batcher = batched_tts(model, batch_size=args.batch_size, chunk_frames=args.chunk_frames,
                          adapter_bank=bank)
    n_fail = 0
    total_audio = 0.0
    t0 = time.time()

    def on_result(i, res):
        nonlocal n_fail, total_audio
        if not isinstance(res, Exception):
            try:
                paths[i].parent.mkdir(parents=True, exist_ok=True)
                audio_io.write_wav(paths[i], res, model.sample_rate)
            except OSError as e:  # disk full / permissions: this item failed,
                res = e           # the rest of the batch must still land
        if isinstance(res, Exception):
            n_fail += 1
            print(f"[{i + 1}/{len(items)}] FAILED {paths[i].name}: {res}", file=sys.stderr)
            return
        total_audio += res.size / model.sample_rate
        if not args.quiet:
            print(f"[{i + 1}/{len(items)}] {paths[i].name}: "
                  f"{res.size / model.sample_rate:.2f}s", file=sys.stderr)

    try:
        batcher.generate_batch([t for t, *_ in items], voices,
                               frames_after_eos=args.frames_after_eos,
                               return_exceptions=True, on_result=on_result, collect=False,
                               adapters=[a for *_, a in items])
    finally:
        batcher.stop()
    dt = time.time() - t0
    print(f"{len(items) - n_fail}/{len(items)} utterances -> {out_dir}: "
          f"{total_audio:.1f}s audio in {dt:.1f}s "
          f"(aggregate {total_audio / max(dt, 1e-9):.1f}x realtime)", file=sys.stderr)
    return 1 if n_fail else 0


def cmd_quantize(args) -> int:
    """Quantize the full-precision checkpoint (int8, or int4 with --bits 4)
    and write the standalone artifact; print the round-trip SNR summary."""
    from pocket_tts_tpu_torch.runtime.quantize import quantize_model, save_quantized, snr_report

    args.quantized = False  # always start from the full-precision checkpoint
    model = _load_model(args)
    _print_device(model)
    qmodel = quantize_model(model, bits=args.bits)
    snrs = snr_report(model.params, qmodel.params)
    save_quantized(qmodel.params, args.output)
    print(f"wrote {args.output}: {len(snrs)} int{args.bits} tensors, "
          f"SNR dB min {min(snrs.values()):.1f} mean "
          f"{sum(snrs.values()) / len(snrs):.1f}", file=sys.stderr)
    return 0


def cmd_finetune(args) -> int:
    """Fine-tune the FlowLM on (text, audio) pairs and write the artifact:
    a full checkpoint, or with ``--lora-rank`` a LoRA adapter; load either
    with ``--finetuned``."""
    from pocket_tts_tpu_torch import audio as audio_io
    from pocket_tts_tpu_torch.training import finetune, save_finetuned_params, save_lora_params

    manifest_dir = Path(args.manifest).parent
    entries = []  # (text, audio path)
    with open(args.manifest, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                obj = json.loads(line)
                text, apath = obj["text"], obj["audio"]
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                print(f"{args.manifest}:{lineno}: need JSONL "
                      f'{{"text": ..., "audio": ...}} ({e})', file=sys.stderr)
                return 2
            entries.append((text, Path(apath) if Path(apath).is_absolute()
                            else manifest_dir / apath))
    if not entries:
        print(f"{args.manifest}: no training pairs", file=sys.stderr)
        return 2

    model = _load_model(args)
    _print_device(model)

    def load_mono(path) -> np.ndarray:
        wav, sr = audio_io.read_wav(path)
        mono = wav.mean(axis=0)
        if sr != model.sample_rate:
            mono = audio_io.resample(mono, sr, model.sample_rate)
        return mono

    try:
        pairs = [(text, load_mono(p)) for text, p in entries]
        voice_wav = load_mono(args.voice_wav) if args.voice_wav else None
    except (OSError, ValueError) as e:
        print(f"cannot read training audio: {e}", file=sys.stderr)
        return 2

    t0 = time.time()
    tuned = finetune(
        model, pairs, steps=args.steps, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, clip_norm=args.clip_norm,
        warmup_steps=args.warmup_steps, eos_weight=args.eos_weight, voice_wav=voice_wav,
        max_tokens=args.max_tokens, seed=args.seed, log_every=args.log_every,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
    if args.lora_rank > 0:
        factors, rank, alpha = tuned._lora
        save_lora_params(factors, args.output, rank=rank, alpha=alpha)
        kind = f"rank-{rank} LoRA adapter"
    else:
        save_finetuned_params(tuned.params["flow_lm"], args.output)
        kind = "full FlowLM checkpoint"
    m = tuned._finetune_metrics
    print(f"wrote {args.output} ({kind}): {len(pairs)} pairs x {args.steps} steps in "
          f"{time.time() - t0:.1f}s, final loss {m.get('loss', float('nan')):.4f} "
          f"(flow {m.get('flow_mse', float('nan')):.4f} "
          f"eos {m.get('eos_bce', float('nan')):.4f})", file=sys.stderr)
    if args.sample_text:
        wav = tuned.generate(args.sample_text)
        sample = Path(args.output).with_suffix(".sample.wav")
        audio_io.write_wav(sample, wav, model.sample_rate)
        print(f"wrote {sample}: fine-tuned sample ({wav.size / model.sample_rate:.2f}s)",
              file=sys.stderr)
    return 0


def _adapter_specs(specs) -> dict[str, str] | None:
    """``--adapter NAME=PATH`` options -> {name: path}; None, with a
    message, for a malformed one."""
    reg: dict[str, str] = {}
    for spec in specs or ():
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            print(f"--adapter must be name=path, got {spec!r}", file=sys.stderr)
            return None
        reg[name] = path
    return reg


def _need_aiohttp(command: str) -> bool:
    """False, with a message, when aiohttp is not installed."""
    if importlib.util.find_spec("aiohttp") is None:
        print(f"{command} needs the aiohttp package, which is not installed", file=sys.stderr)
        return False
    return True


def cmd_serve(args) -> int:
    """The HTTP server; refused before the model loads when it cannot run."""
    adapters = _adapter_specs(args.adapter)
    if adapters is None or not _need_aiohttp("serve"):
        return 2
    from pocket_tts_tpu_torch.server.app import start_server

    model = _load_model(args)
    _print_device(model)
    start_server(model, host=args.host, port=args.port,
                 voice_cache_capacity=args.voice_cache_capacity,
                 default_voice=args.default_voice, prewarm=tuple(args.prewarm or ()),
                 warmup=not args.no_warmup, batch_size=args.batch_size,
                 adapters=adapters or None)
    return 0


def cmd_fleet(args) -> int:
    if not _need_aiohttp("fleet"):
        return 2
    from pocket_tts_tpu_torch.server.fleet import serve_fleet

    urls = [u for part in args.workers for u in part.split(",") if u]
    serve_fleet(urls, host=args.host, port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pocket_tts_tpu_torch",
                                description="Pocket TTS on PyTorch/CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="synthesize speech to a WAV file or stdout")
    g.add_argument("--text", required=True)
    g.add_argument("--voice", default=None,
                   help="predefined name, hf:// URI, .wav/.safetensors path, or base64")
    g.add_argument("--output", "-o", default="output.wav")
    g.add_argument("--stream", action="store_true", help="write raw s16le PCM to stdout")
    g.add_argument("--quiet", "-q", action="store_true")
    g.add_argument("--continuation", type=int, nargs="?", const=120, default=0,
                   metavar="FRAMES",
                   help="condition each segment on the last FRAMES (default 120 = "
                        "9.6 s) of generated audio, for prosody across segments")
    _add_gen_params(g)
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("batch", help="synthesize a manifest of utterances "
                       "concurrently (one WAV each, aggregate throughput)")
    b.add_argument("--manifest", required=True,
                   help='one utterance per line, or JSONL lines '
                        '{"text": ..., "voice"?: ..., "output"?: ...}')
    b.add_argument("--out-dir", "-o", default="batch_out")
    b.add_argument("--voice", default=None,
                   help="default voice for lines that don't specify one")
    b.add_argument("--batch-size", type=int, default=16, help="concurrent decode slots")
    b.add_argument("--chunk-frames", type=int, default=64,
                   help="frames per decode dispatch (the throughput chunk)")
    b.add_argument("--quiet", "-q", action="store_true")
    b.add_argument("--adapter", action="append", metavar="NAME=PATH",
                   help="register a LoRA adapter the manifest's \"adapter\" field can "
                        "select (repeatable); items with different adapters synthesize "
                        "concurrently in one decode loop")
    _add_gen_params(b)
    b.set_defaults(fn=cmd_batch)

    q = sub.add_parser("quantize", help="write an int8 (or int4) weight artifact")
    q.add_argument("--output", "-o", default="model.int8.safetensors")
    q.add_argument("--bits", type=int, choices=(4, 8), default=8,
                   help="8 = int8; 4 = packed int4, half the artifact (~25 dB SNR)")
    _add_gen_params(q)
    q.set_defaults(fn=cmd_quantize)

    t = sub.add_parser("finetune", help="fine-tune the FlowLM on (text, audio) pairs and "
                       "write a checkpoint artifact")
    t.add_argument("--manifest", required=True,
                   help='JSONL lines {"text": ..., "audio": "path.wav"}; relative paths '
                        "resolve against the manifest")
    t.add_argument("--output", "-o", default="model.finetuned.safetensors")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--weight-decay", type=float, default=0.01)
    t.add_argument("--clip-norm", type=float, default=1.0)
    t.add_argument("--warmup-steps", type=int, default=10)
    t.add_argument("--eos-weight", type=float, default=1.0)
    t.add_argument("--lora-rank", type=int, default=0, metavar="R",
                   help="train a rank-R LoRA adapter instead of the full FlowLM "
                        "(0 = full fine-tune)")
    t.add_argument("--lora-alpha", type=float, default=None,
                   help="LoRA scale numerator (delta = alpha/R * B@A; default R)")
    t.add_argument("--max-tokens", type=int, default=None,
                   help="clip each example's text to this many tokens")
    t.add_argument("--voice-wav", default=None, metavar="PATH",
                   help="shared speaker prompt prepended to every example")
    t.add_argument("--log-every", type=int, default=25)
    t.add_argument("--sample-text", default=None,
                   help="synthesize this text with the tuned model to <output>.sample.wav")
    _add_gen_params(t)
    t.set_defaults(fn=cmd_finetune)

    s = sub.add_parser("serve", help="start the HTTP server")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--voice-cache-capacity", type=int, default=8)
    s.add_argument("--default-voice", default="alba")
    s.add_argument("--prewarm", nargs="*", default=[], help="voice specs to preload into the LRU")
    s.add_argument("--no-warmup", action="store_true")
    s.add_argument("--batch-size", type=int, default=0,
                   help=">1 serves concurrent requests through the continuous batcher")
    s.add_argument("--adapter", action="append", metavar="NAME=PATH",
                   help="register a fine-tuned checkpoint or LoRA artifact as a "
                        "request-selectable adapter (repeatable); clients pass "
                        '{"adapter": NAME}')
    _add_gen_params(s)
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("fleet", help="route requests over N serve workers")
    f.add_argument("--host", default="0.0.0.0")
    f.add_argument("--port", type=int, default=8000)
    f.add_argument("--workers", nargs="+", required=True,
                   help="worker base URLs (space- or comma-separated)")
    f.set_defaults(fn=cmd_fleet)
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    # the codec's float32 convolutions in full float32, as the port is checked
    # against its reference (cuDNN's default runs them in TF32)
    torch.backends.cudnn.allow_tf32 = False
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
