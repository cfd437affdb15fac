"""Command line interface (flag parity with the reference cli.py:17-165).

The `analyze` flag surface — --out/--plots/--json/--csv with the
skip|none|false|off sentinels — is the compatibility contract; the
machinery around it is this project's own (artefact options generated by
one factory, destinations routed by one resolver, plus the new
`analyze-batch` multi-chip sweep command).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional, Tuple

import click
from rich.console import Console
from rich.progress import Progress

from . import report as report_module
from .pipeline import analyse_track
from .rendering import outputs as outputs_module
from .utils import enable_persistent_compilation_cache

SKIP_VALUES = {"skip", "none", "false", "off"}

_ARTEFACT_FLAGS = (
    ("plots", "plot PNGs", "directory"),
    ("json", "report.json", "file"),
    ("csv", "CSV tables", "directory"),
)


def _artefact_options(command):
    """Attach the --plots/--json/--csv parity flags to ``command``."""

    for name, what, kind in reversed(_ARTEFACT_FLAGS):
        command = click.option(
            f"--{name}",
            f"{name}_option",
            type=str,
            default=None,
            help=f"Generate {what}. Provide a {kind} path or 'skip' to disable.",
        )(command)
    return command


def _route(value: Optional[str], out_dir: Path) -> Tuple[bool, Optional[Path]]:
    """Map a flag value to (enabled, destination): None keeps the default
    destination, a sentinel disables the artefact, anything else is a
    path override resolved against --out when relative."""

    if value is None:
        return True, None
    if value.lower() in SKIP_VALUES:
        return False, None
    path = Path(value)
    return True, path if path.is_absolute() else (out_dir / path).resolve()


@click.group()
def cli() -> None:
    """Track analyser command line utilities."""


@cli.command("analyze")
@click.argument(
    "audio_path", type=click.Path(exists=True, dir_okay=False, path_type=Path)
)
@click.option(
    "--out",
    "output_dir",
    type=click.Path(file_okay=False, path_type=Path),
    required=True,
    help="Destination for generated artefacts (HTML, MIDI, tables, plots).",
)
@_artefact_options
def analyze_command(
    audio_path: Path,
    output_dir: Path,
    plots_option: Optional[str],
    json_option: Optional[str],
    csv_option: Optional[str],
) -> None:
    """Analyse ``audio_path`` and render artefacts to disk."""

    console = Console()
    output_dir.mkdir(parents=True, exist_ok=True)
    enable_persistent_compilation_cache()

    try:
        with Progress(transient=True) as progress:
            task = progress.add_task("Analysing", total=0)
            seen = 0

            def _advance(_stage: str) -> None:
                nonlocal seen
                seen += 1
                progress.update(task, total=seen)
                progress.advance(task)

            result = analyse_track(audio_path, progress_callback=_advance)

        plots_on, plots_dest = _route(plots_option, output_dir)
        json_on, json_dest = _route(json_option, output_dir)
        csv_on, csv_dest = _route(csv_option, output_dir)
        artefacts = outputs_module.render_all(
            result,
            output_dir,
            report_request=report_module.ReportRequest(
                include_plots=plots_on,
                include_json=json_on,
                include_csv=csv_on,
                plots_dir=plots_dest,
                json_path=json_dest,
                csv_dir=csv_dest,
            ),
        )
        console.print(
            f"[green]Analysis completed[/green] -> {output_dir}\n"
            f"BPM: {result.beat.bpm:.2f}, Key: {result.harmonic.key_estimate.key}\n"
            f"JSON: {artefacts.json if artefacts.json else 'skipped'}\n"
            f"CSV: {_where(artefacts.csv.values())}\n"
            f"Plots: {_where(artefacts.plots.values())}"
        )
    except Exception as exc:
        console.print(f"[red]Error:[/red] {exc}")
        raise SystemExit(1) from exc


def _where(paths: Iterable[Path]) -> str:
    """One directory when everything landed together, else the full list."""

    realised = list(paths)
    if not realised:
        return "skipped"
    parents = {p.parent for p in realised}
    return str(parents.pop()) if len(parents) == 1 else ", ".join(map(str, realised))


@cli.command("analyze-batch")
@click.argument(
    "audio_paths",
    type=click.Path(exists=True, dir_okay=False, path_type=Path),
    nargs=-1,
    required=True,
)
@click.option(
    "--out",
    "output_dir",
    type=click.Path(file_okay=False, path_type=Path),
    required=True,
    help="Destination root; each track renders into OUT/<stem>/.",
)
@click.option(
    "--manifest",
    "manifest_path",
    type=click.Path(dir_okay=False, path_type=Path),
    default=None,
    help="JSONL manifest for resumable sweeps (skips already-listed tracks).",
)
@click.option(
    "--upload-streams",
    type=int,
    default=2,
    show_default=True,
    help="Concurrent host->device upload streams.",
)
@click.option(
    "--decode-workers",
    type=int,
    default=None,
    help="Host decode/quantise worker threads [default: cores-1].",
)
@click.option(
    "--transport",
    type=click.Choice(["ms", "ms6", "ms5", "int8", "int16"]),
    default="ms",
    show_default=True,
    help="Host->device payload precision: 'ms' ships the mid channel "
    "only as blockwise int8 (1 byte per stereo sample pair; stereo "
    "scalars and widths are host-exact; every accuracy gate holds); "
    "'ms6' packs 6-bit mid codes, per block raw or delta-coded "
    "(0.75 B/pair — every accuracy gate holds, see RUNBOOK); 'ms5' "
    "packs noise-shaped 5-bit codes on a 64x finer scale grid "
    "(0.63 B/pair, least bytes — every accuracy gate holds incl. the "
    "±0.1 dense-mix BPM bound, see tests/test_agreement.py); "
    "'int8'/'int16' for bit-critical work.",
)
@click.option(
    "--prewarm/--no-prewarm",
    "prewarm",
    default=None,
    help="Compile each bucket executable in the background as soon as "
    "the bucket is first seen (default: on for accelerator backends).",
)
@click.option(
    "--device-batch",
    type=int,
    default=1,
    show_default=True,
    help="Tracks analysed per device per dispatch. >1 amortises "
    "per-dispatch overhead for large same-length libraries at the cost "
    "of one extra compile per bucket and zero-padding of partial chunks.",
)
@click.option(
    "--shard",
    "shard_spec",
    type=str,
    default=None,
    help="'i/n' for multi-process sweeps: this process analyses every "
    "n-th source starting at i (0-based). Tracks are independent, so "
    "slices/hosts scale with NO cross-process communication — launch "
    "one process per slice with distinct i and the same source list.",
)
def analyze_batch_command(
    audio_paths: tuple,
    output_dir: Path,
    manifest_path: Optional[Path],
    upload_streams: int,
    decode_workers: int,
    transport: str,
    prewarm: Optional[bool],
    device_batch: int,
    shard_spec: Optional[str],
) -> None:
    """Analyse a library of tracks with batched, data-parallel dispatches."""

    console = Console()
    output_dir.mkdir(parents=True, exist_ok=True)
    enable_persistent_compilation_cache()

    shard = None
    if shard_spec is not None:
        try:
            idx_s, count_s = shard_spec.split("/", 1)
            shard = (int(idx_s), int(count_s))
        except ValueError:
            raise click.BadParameter("expected 'i/n', e.g. --shard 0/4", param_hint="--shard")

    from .parallel.batch import SkippedTrack, TrackFailure, analyse_library

    try:
        with Progress(transient=True) as progress:
            task = progress.add_task("Analysing library", total=len(audio_paths))

            def _tick(_src: str, done: int, total: int) -> None:
                progress.update(task, completed=done, total=total)

            outcomes = analyse_library(
                [str(p) for p in audio_paths],
                output_dir=output_dir,
                manifest_path=manifest_path,
                progress_callback=_tick,
                upload_streams=upload_streams,
                decode_workers=decode_workers,
                transport=transport,
                prewarm=prewarm,
                device_batch=device_batch,
                shard=shard,
            )
        results = [r for r in outcomes if not isinstance(r, (TrackFailure, SkippedTrack))]
        failures = [r for r in outcomes if isinstance(r, TrackFailure)]
        skipped = [
            r for r in outcomes if isinstance(r, SkippedTrack) and r.reason == "manifest"
        ]
        elsewhere = [
            r for r in outcomes if isinstance(r, SkippedTrack) and r.reason == "other-shard"
        ]
        console.print(
            f"[green]Library analysis completed[/green] -> {output_dir} "
            f"({len(results)} track(s)"
            + (f", {len(skipped)} already done" if skipped else "")
            + (f", {len(elsewhere)} on other shards" if elsewhere else "")
            + (f", {len(failures)} failed" if failures else "")
            + ")"
        )
        for result in results:
            console.print(
                f"  {Path(result.audio.path or '?').name}: "
                f"BPM {result.beat.bpm:.2f}, key {result.harmonic.primary_key.key}"
            )
        for failure in failures:
            console.print(f"  [red]{Path(failure.source).name}: {failure.error}[/red]")
    except Exception as exc:
        console.print(f"[red]Error:[/red] {exc}")
        raise SystemExit(1) from exc


def main() -> None:
    cli()


if __name__ == "__main__":
    main()
