"""Session driver: per-hop acquisition and the outer measurement loop.

Port of ``rtl_power_fftw_tpu/session.py`` for the averaged PSD of one
stream or of ``--streams`` parallel sources. It re-implements the
reference's ``Acquisition`` controller (acquisition.cxx:211-441) and
``main``'s session loop
(rtl_power_fftw.cxx:50-233): tune-with-retries, the producer read loop with
dropped-sample retry and strict-time deadline, per-hop output, frequency
hopping with TuneError dropping, endless/duration-bounded sessions, SIGINT
escalation, and the matrix-mode metadata lifecycle. Its printouts, output
files and exit codes are those of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import IO, Optional

import numpy as np
import torch

from .auxdata import AuxData
from .config import BASE_BUF, Params
from .exceptions import ReturnValue, RPFexception, StreamEOF, TuneError
from .interrupts import InterruptState, check_interrupt, set_ctrl_c_handler
from .ops.spectral import bin_frequencies, finalize_psd
from .output.matrix import MatrixWriter
from .output.stats import SessionStats
from .output.text import TextWriter
from .parallel.mesh import make_mesh
from .parallel.multistream import MultiStreamAcquisition
from .pipeline.datastore import Datastore
from .planning import Plan
from .sources.base import IQSource
from .sources.registry import make_sources


def current_datetime() -> str:
    """UTC timestamp "YYYY-MM-DD HH:MM:SS UTC" (acquisition.cxx:436-441)."""
    return time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())


def _chatty(params: Params) -> bool:
    """The reference's verbosity gate, repeated at every printout:
    ``(outcnt == 0 && talkless) || !talkless`` (e.g. acquisition.cxx:233)."""
    return (params.outcnt == 0 and params.talkless) or not params.talkless


def check_ported(params: Params) -> None:
    """Raise RPFexception(InvalidArgument) for options whose path this
    package does not have yet."""
    unported = []
    if params.shard_transform:
        unported.append("--shard-transform")
    if params.pfb_taps:
        unported.append("--pfb-taps")
    if params.multitaper:
        unported.append("--multitaper")
    if params.sk_file:
        unported.append("--sk-file")
    if params.sk_excise > 0.0:
        unported.append("--sk-excise")
    if params.profile_dir:
        unported.append("--profile")
    if unported:
        raise RPFexception(
            "Not yet ported to the PyTorch/CUDA package: "
            + ", ".join(unported) + ". Exiting.",
            ReturnValue.InvalidArgument)


class Acquisition:
    """One data acquisition at one tuned frequency (acquisition.cxx:211-348)."""

    def __init__(self, params: Params, aux: AuxData, source: IQSource,
                 data: Optional[Datastore], actual_samplerate: int, freq: int,
                 stats: SessionStats, stderr: Optional[IO[str]] = None,
                 multistream: Optional[MultiStreamAcquisition] = None,
                 record=None):
        self.params = params
        self.aux = aux
        self.source = source
        self.data = data
        self.actual_samplerate = actual_samplerate
        self.freq = freq
        self.stats = stats
        self.err = stderr if stderr is not None else sys.stderr
        self.tuned_freq = 0
        self.startAcqTimestamp = ""
        self.endAcqTimestamp = ""
        self.deviceReadouts = 0
        self.successfulReadouts = 0
        self.repeats_done = 0
        self.pwr: Optional[np.ndarray] = None
        self.multistream = multistream
        self.multistream_repeats: Optional[np.ndarray] = None
        self.record = record      # open binary file: raw consumed IQ copy
        self.stream_eof = False

    def run(self) -> None:
        params = self.params
        # Tune with up to 3 tries (acquisition.cxx:229-249): hardware can be
        # stubborn; a zero readback also counts as failure.
        max_tune_tries = 3
        success = False
        for tune_try in range(max_tune_tries):
            if success:
                break
            if _chatty(params):
                print(f"Tuning to {self.freq} Hz (try {tune_try + 1})", file=self.err)
            try:
                self.source.set_frequency(self.freq)
                self.tuned_freq = self.source.frequency()
                if self.tuned_freq != 0:
                    success = True
            except RPFexception:
                pass
        if not success:
            raise TuneError(self.freq)

        if _chatty(params):
            print(f"Device tuned to: {self.tuned_freq} Hz", file=self.err)

        if self.multistream is not None:
            # Parallel streams: the engine drives its own per-stream
            # producers and the cross-stream sum. Tune EVERY stream before
            # the scan-start bookkeeping: a dead extra stream must drop the
            # hop BEFORE begin_scan, or the failed attempt's timestamp
            # poisons the .met metadata (the reference tunes before
            # recording scan time, acquisition.cxx:229-249 vs 259-264).
            self.multistream.tune_all(self.freq)
            self.startAcqTimestamp = current_datetime()
            self.stats.begin_scan(self.startAcqTimestamp)
            if _chatty(params):
                print(f"Acquisition started at {self.startAcqTimestamp}",
                      file=self.err)
            result = self.multistream.run(self.freq)
            self.endAcqTimestamp = current_datetime()
            self.stats.end_scan(self.endAcqTimestamp)
            if _chatty(params):
                print(f"Acquisition done at {self.endAcqTimestamp}",
                      file=self.err)
            self.pwr = result.pwr
            self.repeats_done = int(result.repeats_done.sum())
            self.multistream_repeats = result.repeats_done
            self.deviceReadouts = result.device_readouts
            self.successfulReadouts = result.successful_readouts
            self.stream_eof = result.stream_eof
            return

        self.data.begin_acquisition()

        self.startAcqTimestamp = current_datetime()
        self.stats.begin_scan(self.startAcqTimestamp)
        if _chatty(params):
            print(f"Acquisition started at {self.startAcqTimestamp}", file=self.err)

        # Strict-time deadline (acquisition.cxx:267-269).
        stop_time = time.monotonic() + params.integration_time

        # 2·N·repeats without overlap (acquisition.cxx:273); scaled down by
        # hop/N in Welch mode where frames reuse samples.
        data_total = self.data.bytes_needed()
        data_read = 0

        while data_read < data_total:
            self.data.acquire_slot()

            # Figure out how much data to read (acquisition.cxx:287-302):
            # full buffers while possible; the final partial read rounds up
            # to the next multiple of BASE_BUF.
            data_needed = data_total - data_read
            if data_needed >= params.buf_length:
                data_needed = params.buf_length
            else:
                data_needed = BASE_BUF * int(math.ceil(data_needed / BASE_BUF))
                if data_needed > params.buf_length:
                    data_needed = params.buf_length

            try:
                buffer, read_success = self.source.read(data_needed)
            except StreamEOF as eof:
                # Recorded stream ran out: keep whatever tail bytes were
                # already buffered and finish the partial spectrum — the
                # strict-time semantics (acquisition.cxx:326-331), not a
                # fatal AcquisitionError.
                if eof.partial is not None and len(eof.partial):
                    if self.record is not None:
                        self.record.write(eof.partial.tobytes())
                    self.data.push_buffer(eof.partial)
                self.stream_eof = True
                print(f"End of input stream: {eof}", file=self.err)
                break
            self.deviceReadouts += 1

            if not read_success:
                print("Error: dropped samples.", file=self.err)
                # No data in this buffer — the slot was never handed over,
                # so simply retry (acquisition.cxx:307-316).
            else:
                self.successfulReadouts += 1
                data_read += data_needed
                if self.record is not None:
                    # Raw-IQ capture (extension): the consumed byte stream,
                    # exactly what --source file:<record> would replay.
                    self.record.write(buffer.tobytes())
                self.data.push_buffer(buffer)

            if params.strict_time and time.monotonic() >= stop_time:
                break
            if check_interrupt(InterruptState.FinishNow, stderr=self.err):
                break

        self.endAcqTimestamp = current_datetime()
        self.stats.end_scan(self.endAcqTimestamp)
        if _chatty(params):
            print(f"Acquisition done at {self.endAcqTimestamp}", file=self.err)

        result = self.data.finish_acquisition()
        self.pwr = result.pwr
        self.repeats_done = result.repeats_done

    def unique_samples(self) -> int:
        """Unique (complex) samples consumed — N·repeats_done, except in
        Welch-overlap mode where frames share samples."""
        if self.multistream is not None:
            # Per-stream overlap: sum hop·(r_s−1)+N over streams.
            return self.multistream.unique_samples(self.multistream_repeats)
        return self.data.unique_samples(self.repeats_done)

    def print_summary(self) -> None:
        """acquisition.cxx:350-358."""
        err = self.err
        print(f"Actual number of (complex) samples collected: "
              f"{self.unique_samples()}", file=err)
        print(f"Actual number of device readouts: {self.deviceReadouts}", file=err)
        print(f"Number of successful readouts: {self.successfulReadouts}", file=err)
        print(f"Actual number of averaged spectra: {self.repeats_done}", file=err)
        eff = float(self.unique_samples()) / self.actual_samplerate
        print(f"Effective integration time: {eff:g} seconds", file=err)

    def compute_output(self) -> np.ndarray:
        """Finalize the accumulated spectrum into output values
        (acquisition.cxx:376-399): fftshift + DC interp + normalize +
        dB/linear + baseline."""
        baseline = self.aux.baseline_values if self.params.baseline else None
        with np.errstate(divide="ignore", invalid="ignore"):
            return finalize_psd(self.pwr, self.repeats_done,
                                self.actual_samplerate,
                                linear=self.params.linear,
                                baseline=baseline)

    def write_data(self, text_writer: TextWriter,
                   matrix_writer: Optional[MatrixWriter]) -> np.ndarray:
        """acquisition.cxx:360-433. Returns the computed output values
        (used by the live stitch extension)."""
        values = self.compute_output()
        if self.params.matrixMode:
            matrix_writer.append_row(values, self.tuned_freq, self.params.finalfreq)
        else:
            freqs = bin_frequencies(self.tuned_freq, self.params.N,
                                    self.actual_samplerate)
            text_writer.write_spectrum(
                freqs, values, self.startAcqTimestamp, self.endAcqTimestamp,
                self.tuned_freq, self.actual_samplerate, self.params.N)
        return values


def run_session(params: Params, source: IQSource, aux: AuxData, *,
                device: torch.device,
                stdout: Optional[IO[str]] = None,
                stderr: Optional[IO[str]] = None,
                install_sigint: bool = True) -> ReturnValue:
    """The measurement session (rtl_power_fftw.cxx:50-233 after device
    setup), with its device step on ``device``.

    Returns the final ReturnValue; raises RPFexception for fatal errors
    (the CLI converts both to exit codes).
    """
    check_ported(params)
    err = stderr if stderr is not None else sys.stderr
    out = stdout if stdout is not None else sys.stdout
    stats = SessionStats()

    # endless takes precedence over session duration (rtl_power_fftw.cxx:69).
    if params.endless:
        params.session_duration_isSet = False
    if params.session_duration_isSet:
        print(f"Scan session duration: {int(params.session_duration)} seconds",
              file=err)

    # Gain setup (rtl_power_fftw.cxx:77-82).
    source.print_gains(stderr=err)
    gain = source.nearest_gain(params.gain)
    print(f"Selected nearest available gain: {gain} ({0.1 * gain:g} dB)", file=err)
    source.set_gain(gain)

    # Throwaway pre-tune so the sample-rate setting has a valid frequency
    # (rtl_power_fftw.cxx:84-91).
    try:
        source.set_frequency(params.cfreq)
    except RPFexception:
        pass

    if params.ppm_error != 0:
        source.set_freq_correction(params.ppm_error)
        print(f"PPM error set to: {params.ppm_error}", file=err)

    source.set_sample_rate(params.sample_rate)
    actual_samplerate = source.sample_rate()
    print(f"Actual sample rate: {actual_samplerate} Hz", file=err)

    plan = Plan(params, actual_samplerate)
    plan.print(file=err)

    # One engine owns the compute path: with --streams (extension; BASELINE
    # config 5) the multi-stream engine, else the single-stream Datastore.
    # Stream 0 is the primary source (keeps tune/retry semantics); extra
    # streams come from the same --source spec.
    multistream = None
    data = None
    if params.streams > 1:
        extra = make_sources(params.source, params.streams - 1,
                             params.sample_rate)
        for s in extra:
            # Extras get the full device setup the primary received
            # (rtl_power_fftw.cxx:77-101): matched gain, ppm, rate —
            # averaging streams with mismatched gains would silently skew
            # the combined spectrum.
            s.set_gain(s.nearest_gain(params.gain))
            if params.ppm_error != 0:
                s.set_freq_correction(params.ppm_error)
            s.set_sample_rate(params.sample_rate)
        if params.precision != "highest":
            print("Warning: --precision high does not apply to the "
                  "multi-stream sharded path.", file=err)
        multistream = MultiStreamAcquisition(
            params, [source] + extra, make_mesh(device),
            window=aux.window_values, frames_per_step=params.frames_per_step)
        print(f"Parallel streams: {params.streams} "
              f"(mesh size {len(multistream.step.devices)})", file=err)
        transform_path = multistream.step.path
    else:
        data = Datastore(params, device, window=aux.window_values)
        transform_path = data.transform_path

    if _chatty(params):
        print(f"Transform path: {transform_path} "
              f"(backend={params.fft_backend}, N={params.N})", file=err)

    if install_sigint:
        set_ctrl_c_handler(True)

    exit_time = None
    if params.session_duration_isSet:
        exit_time = time.time() + int(params.session_duration)

    text_writer = TextWriter(out)
    matrix_writer = None
    if params.matrixMode:
        matrix_writer = MatrixWriter(params.bin_file, params.meta_file, stats)
        matrix_writer.truncate()

    record = None
    stats_stream = None
    try:
        if params.record_file and multistream is None:
            # Raw-IQ capture (extension): one file for the whole session;
            # with hopping the per-hop streams are appended in scan order.
            record = open(params.record_file, "wb")
            print(f"Recording raw IQ to {params.record_file}", file=err)
        elif params.record_file:
            # Multi-stream: one file per stream (<file>.s<i>), written by
            # the per-stream producers.
            multistream.start_recording(params.record_file, stderr=err)
        if params.stats_json:
            stats_stream = open(params.stats_json, "a")
        if params.stitch_file:
            # Validate writability up front — failing five minutes into a
            # scan because the directory doesn't exist helps nobody.
            with open(params.stitch_file, "a"):
                pass
    except BaseException as e:
        # A later open failing must not leak the files already opened.
        for f in (record, stats_stream):
            if f is not None:
                f.close()
        if multistream is not None:
            multistream.stop_recording()
        if isinstance(e, OSError):
            raise RPFexception(f"Could not open output file: {e}. Exiting.",
                               ReturnValue.InvalidInput)
        raise

    try:
        return _session_loop(params, aux, source, data, multistream, record,
                             plan, stats, actual_samplerate, transform_path,
                             text_writer, matrix_writer, err, exit_time,
                             stats_stream)
    finally:
        # Close capture files on EVERY exit path (errors included), so
        # buffered tails are flushed and library callers don't leak fds.
        for f in (record, stats_stream):
            if f is not None:
                f.close()
        if multistream is not None:
            multistream.stop_recording()


def _write_stitch(stitch_file: str, pass_spectra, linear: bool) -> None:
    """Rewrite the merged wideband spectrum (overlaps averaged in linear
    power unless --linear; utils/stitch.py) atomically."""
    from .utils.stitch import merge_spectra
    sfreqs, svals = merge_spectra(pass_spectra, db=not linear)
    tmp = stitch_file + ".tmp"
    with open(tmp, "w") as sf:
        sf.write(f"# stitched spectrum: {len(pass_spectra)} "
                 f"hops, {len(sfreqs)} bins\n")
        for f_, v_ in zip(sfreqs, svals):
            sf.write(f"{f_:.10g} {v_:.6g}\n")
    os.replace(tmp, stitch_file)


def _session_loop(params, aux, source, data, multistream, record, plan,
                  stats, actual_samplerate, transform_path, text_writer,
                  matrix_writer, err, exit_time, stats_stream) -> ReturnValue:
    """The measurement loop proper (rtl_power_fftw.cxx:132-225)."""
    params.finalfreq = plan.freqs_to_tune[-1]
    freqs_meta_needed = True
    do_exit = False
    last_repeats_done = 0
    any_written = False
    stream_ended = False
    # In --streams mode there is no single-stream Datastore; the queue
    # diagnostics come from the multistream engine.
    hist_source = multistream if multistream is not None else data

    while not do_exit:
        i = 0
        pass_spectra = []   # (freqs, values) per hop for the live stitch
        while i < len(plan.freqs_to_tune):
            freq = plan.freqs_to_tune[i]
            hist_before = list(hist_source.queue_histogram)
            acquisition = Acquisition(params, aux, source, data,
                                      actual_samplerate, freq, stats,
                                      stderr=err, multistream=multistream,
                                      record=record)
            try:
                acquisition.run()
                i += 1
            except TuneError as e:
                # Dead spot of the receiver: drop the frequency and continue
                # (rtl_power_fftw.cxx:141-147).
                print(f"Unable to tune to {e.frequency()}. "
                      "Dropping from frequency list.", file=err)
                del plan.freqs_to_tune[i]
                continue

            if acquisition.stream_eof:
                stream_ended = True
            if acquisition.stream_eof and acquisition.repeats_done == 0:
                # The stream ended before this hop produced a single
                # spectrum. If earlier hops wrote data the session simply
                # ends; a stream too short for even one spectrum is an
                # input error (exceptions.h:25-34).
                if not any_written:
                    raise RPFexception(
                        "Input stream ended before a single spectrum "
                        "could be averaged.", ReturnValue.AcquisitionError)
                do_exit = True
                break

            last_repeats_done = acquisition.repeats_done
            if _chatty(params):
                acquisition.print_summary()

            # Matrix-mode frequency extents, once per run
            # (rtl_power_fftw.cxx:153-163).
            if params.matrixMode and freqs_meta_needed:
                tunfreq = plan.freqs_to_tune[0]
                stats.startFreq = int(
                    tunfreq + (0 - params.N / 2.0) * actual_samplerate / params.N)
                tunfreq = plan.freqs_to_tune[-1]
                stats.endFreq = int(
                    tunfreq + ((params.N - 1) - params.N / 2.0)
                    * actual_samplerate / params.N)
                stats.stepFreq = actual_samplerate // params.N
                freqs_meta_needed = False

            values = acquisition.write_data(text_writer, matrix_writer)
            any_written = True
            if params.stitch_file:
                pass_spectra.append(
                    (bin_frequencies(acquisition.tuned_freq, params.N,
                                     actual_samplerate), values))

            # Observability extension: machine-readable per-scan stats
            # (the reference only prints these to stderr,
            # acquisition.cxx:350-358 + datastore.cxx:98-103).
            if stats_stream is not None:
                stats_stream.write(json.dumps({
                    "tuned_freq": acquisition.tuned_freq,
                    "transform_path": transform_path,
                    "start": acquisition.startAcqTimestamp,
                    "end": acquisition.endAcqTimestamp,
                    "repeats_done": acquisition.repeats_done,
                    "device_readouts": acquisition.deviceReadouts,
                    "successful_readouts": acquisition.successfulReadouts,
                    "effective_integration_s":
                        float(acquisition.unique_samples())
                        / actual_samplerate,
                    # Per-scan delta (the histogram is cumulative
                    # across the session).
                    "queue_histogram": [a - b for a, b in
                                        zip(hist_source.queue_histogram,
                                            hist_before)],
                }) + "\n")
                stats_stream.flush()

            if _chatty(params):
                hist_source.print_queue_histogram(stderr=err)

            if acquisition.stream_eof:
                # Partial spectrum written; nothing more will ever arrive.
                do_exit = True
                break

            if check_interrupt(InterruptState.FinishNow, stderr=err):
                break

        # Live stitch extension: rewrite the merged wideband spectrum
        # after every completed pass — a continuously refreshed view for
        # endless scans, like the incremental .met refresh.
        if params.stitch_file and pass_spectra:
            try:
                _write_stitch(params.stitch_file, pass_spectra, params.linear)
            except OSError as e:
                # A live-view failure (disk full, path removed) must not
                # kill the measurement: warn once and stop refreshing.
                print(f"Warning: could not refresh {params.stitch_file}: "
                      f"{e}; live stitching disabled.", file=err)
                params.stitch_file = ""

        if params.outcnt == 0 and params.talkless:
            params.outcnt += 1

        # The measurement-set separator blank line is written to stdout
        # unconditionally — even in matrix mode (rtl_power_fftw.cxx:184-194).
        if params.session_duration_isSet:
            if time.time() >= exit_time:
                do_exit = True
                print("Session duration elapsed.", file=err)
                text_writer.end_measurement_set()
        else:
            text_writer.end_measurement_set()

        if params.endless:
            do_exit = False
        if not params.session_duration_isSet and not params.endless:
            do_exit = True
        if stream_ended:
            # A finite stream ran dry: even --endless cannot continue.
            do_exit = True
        if check_interrupt(InterruptState.FinishPass, stderr=err):
            do_exit = True

        # Checkpoint extension (SURVEY §5): refresh the .met sidecar after
        # every completed pass — same final bytes, crash-safe.
        if params.matrixMode and matrix_writer is not None and not do_exit:
            matrix_writer.write_meta(params.N, last_repeats_done,
                                     actual_samplerate)

    if params.matrixMode and matrix_writer is not None:
        matrix_writer.write_meta(params.N, last_repeats_done, actual_samplerate)

    if len(plan.freqs_to_tune) == 0:
        raise RPFexception("No valid frequencies left.",
                           ReturnValue.AcquisitionError)

    return ReturnValue.Success
