"""Command-line interface of the port: ``generate`` and ``batch`` (port of
those subcommands of ``pocket_tts_tpu/cli.py``).

    python -m pocket_tts_tpu_torch.cli generate --text "Hello." -o out.wav
    python -m pocket_tts_tpu_torch.cli batch --manifest lines.txt -o out_dir

``generate --stream`` writes raw s16le PCM to stdout.  ``batch`` synthesizes
a manifest (plain lines, or JSONL ``{"text", "voice"?, "output"?}``)
concurrently through the continuous batcher, one WAV per line.  ``--device``
picks the torch device (default ``cuda``; with no card visible the command
fails unless ``--device cpu`` is given); its name is printed on stderr.
"""

from __future__ import annotations

import argparse
import collections
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; --device cpu runs on the CPU)")


def _load_model(args):
    from pocket_tts_tpu_torch.tts import TTSModel

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    return TTSModel.load_with_params(
        args.variant, temp=args.temperature, lsd_decode_steps=args.lsd_decode_steps,
        noise_clamp=args.noise_clamp, eos_threshold=args.eos_threshold,
        seed=args.seed, device=args.device)


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
    """Manifest -> [(text, voice spec | None, output name | None)].  Plain
    lines are bare utterances; lines that start with "{" are JSONL; blank
    lines and "#" comments are skipped.  Raises ValueError on a bad entry."""
    items = []
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if not line.startswith("{"):
                items.append((line, None, None))
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
            if "adapter" in obj:
                raise ValueError(f"{path}:{lineno}: \"adapter\" is not supported "
                                 "(per-slot LoRA adapters are not ported yet)")
            items.append((text, obj.get("voice"), out_name))
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
    paths = []
    for i, (_, _, name) in enumerate(items):
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
    resolved: dict[str, object] = {}
    voices = []
    for _, spec, _ in items:
        spec = spec or args.voice
        if spec is None:
            voices.append(None)
            continue
        if spec not in resolved:  # a voice encode is a prefill: once per spec
            try:
                resolved[spec] = voices_mod.resolve_voice(model, spec)
            except Exception as e:  # noqa: BLE001
                # fail before synthesis: a batch silently re-voiced to the
                # default would waste the run
                print(f"voice {spec!r} unresolvable: {e}", file=sys.stderr)
                return 2
        voices.append(resolved[spec])

    batcher = batched_tts(model, batch_size=args.batch_size, chunk_frames=args.chunk_frames)
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
        batcher.generate_batch([t for t, _, _ in items], voices,
                               frames_after_eos=args.frames_after_eos,
                               return_exceptions=True, on_result=on_result, collect=False)
    finally:
        batcher.stop()
    dt = time.time() - t0
    print(f"{len(items) - n_fail}/{len(items)} utterances -> {out_dir}: "
          f"{total_audio:.1f}s audio in {dt:.1f}s "
          f"(aggregate {total_audio / max(dt, 1e-9):.1f}x realtime)", file=sys.stderr)
    return 1 if n_fail else 0


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
    _add_gen_params(b)
    b.set_defaults(fn=cmd_batch)
    return p


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
