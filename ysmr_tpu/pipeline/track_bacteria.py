#!/usr/bin/env python3
"""track_bacteria(): video -> _list.csv via device-batched detect + track.

Public stage-1 entry point with the reference's contract
(track_eval.py:38-405): validates the file and frame count, honours the fps
settings, writes the ``_list.csv`` artifact incrementally (flushed every
``list save length interval`` rows), restores a renamed previous list on
error, logs the end-of-run throughput line, and returns
``(df, fps, frame_height, frame_width, csv_path)``.

The per-frame Python loop of the reference is replaced by: background host
decode (io/video.py) -> jitted batched detection (pipeline/detect.py) ->
jitted tracker scan (pipeline/tracker.py) -> host CSV compaction. Device
work for batch N+1 overlaps host writing of batch N.
"""

import logging
import os
import threading
from functools import partial

import numpy as np

from ysmr_tpu.config import get_configs
from ysmr_tpu.io.video import BatchedVideoReader, VideoReadError
from ysmr_tpu.ops import gsff as gsff_ops
from ysmr_tpu.ops import preprocess as pp
from ysmr_tpu.pipeline import detect as det
from ysmr_tpu.pipeline import tracker as trk
from ysmr_tpu.utils.csv_io import finalize_sorted_list, save_list, sort_list
from ysmr_tpu.utils.files import create_results_folder
from ysmr_tpu.utils.logging_utils import get_loggers

_H2D_BANDWIDTH = None

#: benchmark hook: force the padded (multi-array) emissions readback so the
#: single-buffer device compaction can be A/B-timed in one process
_FORCE_PADDED_READBACK = False

#: per-backend defaults of the pixels-mode device path choices ('auto' in
#: the settings); each pair of choices produces identical output. GPU: the
#: faster of each pair on an H100 (bench.py --device-paths, 64-frame
#: batches of the bench clip: run-graph CC 1.2 ms/batch vs stencil CC 11.9
#: ms sorted / 26.1 ms scatter compaction). CPU: the whole-frame stencil
#: labeling with scatter/gather compaction.
_DEVICE_PATH_DEFAULTS = {
    'cpu': {'run_cc': False, 'sort_compact': False},
    'gpu': {'run_cc': True, 'sort_compact': True},
}

#: last completed run's per-frame stage split (ms/frame), for callers that
#: want the 'profile stages' numbers programmatically (bench.py carries the
#: median-rep split in its record so the headline-vs-floor gap is evidenced,
#: not asserted). Written once per finished track_bacteria() call.
LAST_STAGE_SPLIT = None

_SLICE_JITS = {}


def _slice_cols_with_counts(k):
    """Jitted (T, F), (T,) -> (T, k+1) int16: the det_px_idx readback sliced
    to the batch's pixel-count bucket with n_components folded into a final
    extra column — ONE device buffer, hence ONE d2h fetch per batch (each
    fetch pays the link's fixed latency regardless of size)."""
    if k not in _SLICE_JITS:
        import jax
        import jax.numpy as jnp

        def f(a, n):
            return jnp.concatenate(
                [a[:, :k], n[:, None].astype(jnp.int16)], axis=1)

        _SLICE_JITS[k] = jax.jit(f)
    return _SLICE_JITS[k]


def _next_pow2(n):
    return 1 << max(int(n) - 1, 1).bit_length()


def _expand_run_det(px_runs, run_counts, det_run, f_bucket):
    """Per-pixel detection indices from the per-run readback.

    Exact: the wire encoder (native encode_runs_batch) consumed the packed
    pixels in order, so repeating each run's det index by its length field
    (bits 27..31) reproduces the wire-order per-pixel table the device used
    to ship whole (native cv2_rects_batch contract).
    """
    t = px_runs.shape[0]
    out = np.full((t, f_bucket), -1, np.int16)
    lens_all = (px_runs >> np.uint32(27)).astype(np.int64)
    for ti in range(t):
        rcnt = int(run_counts[ti])
        if rcnt == 0:
            continue
        exp = np.repeat(det_run[ti, :rcnt], lens_all[ti, :rcnt])
        out[ti, :exp.size] = exp
    return out


_RECT_LUM_JIT = None


def _det_xy_with_rect_lum(gray_frames, rects, valid, win):
    """(cx, cy, ILLUMINATION) detection positions on device: the exact
    filled-rotated-rect luminosity (ops/luminosity.py) evaluated at the
    HOST-measured cv2-exact rects, so the stored value corresponds to the
    row's own rect parameters (reference track_eval.py:290-300)."""
    global _RECT_LUM_JIT
    if _RECT_LUM_JIT is None:
        import jax
        import jax.numpy as jnp
        from ysmr_tpu.ops.luminosity import rect_mean_luminosity

        @partial(jax.jit, static_argnames=('win',))
        def f(gray, rects_b, valid_b, *, win):
            def per_frame(g, r, v):
                return rect_mean_luminosity(g, r[:, 0], r[:, 1], r[:, 2],
                                            r[:, 3], r[:, 4], v, win=win)
            lum = jax.vmap(per_frame)(gray, rects_b, valid_b)
            return jnp.stack([rects_b[..., 0], rects_b[..., 1], lum], axis=-1)

        _RECT_LUM_JIT = f
    return _RECT_LUM_JIT(gray_frames, rects, valid, win=win)


def probe_h2d_bandwidth(n_probes=3):
    """Measured host->device bandwidth in bytes/s (cached per process).

    Median of ``n_probes`` separate transfers: a single noisy probe would
    pick the wrong transfer mode for the whole run.
    """
    global _H2D_BANDWIDTH
    if _H2D_BANDWIDTH is None:
        import time
        import jax
        import jax.numpy as jnp
        x = np.zeros(4 * 1024 * 1024, np.uint8)
        f = jax.jit(lambda a: jnp.sum(a[::65536].astype(jnp.int32)))
        f(x).block_until_ready()  # compile + first transfer
        samples = []
        for i in range(n_probes):
            t0 = time.perf_counter()
            f(x + np.uint8(i + 1)).block_until_ready()
            samples.append(len(x) / max(time.perf_counter() - t0, 1e-6))
        _H2D_BANDWIDTH = float(np.median(samples))
    return _H2D_BANDWIDTH


def resolve_transfer_mode(settings, frame_bytes):
    """'auto' picks pixels mode when streaming frames cannot beat ~60 fps.

    On the CPU backend host==device: streaming whole frames buys nothing and
    the whole-frame stencil labeling is far slower than the compact-table
    path, so 'auto' always picks pixels there.
    """
    mode = settings.get('transfer mode', 'auto')
    if mode in ('frames', 'pixels'):
        return mode
    import jax
    if jax.default_backend() == 'cpu':
        return 'pixels'
    bandwidth = probe_h2d_bandwidth()
    return 'pixels' if bandwidth < 60 * frame_bytes else 'frames'


def resolve_batch_size(settings, transfer_mode, backend, has_display):
    """Per-run frame batch size.

    Display mode bounds preview latency. Pixels mode on an accelerator
    rounds small batches up to 64 — the pixel tables are tiny and the
    bigger batch amortises the per-dispatch latency of the link.
    """
    batch_size = settings['frame batch size']
    if has_display:
        return min(batch_size, 16)
    if transfer_mode == 'pixels' and batch_size < 64 and backend != 'cpu':
        return 64
    return batch_size


def device_path_flags(settings, backend):
    """Choices of the pixels-mode device path, decided once per run.

    ``run_cc``: label connected components on the run-length tables
    (ops/run_cc.py) instead of rasterizing whole frames for the stencil
    labeling — needs the run wire. ``sort_compact``: compact components
    with one sort and bit-packed marker reconstruction instead of
    scatter/gather compaction (pipeline/detect_pixels.py). Both settings of
    each flag produce identical output. Both take the backend's default
    (``_DEVICE_PATH_DEFAULTS``; backends not listed take the CPU's);
    ``'run cc'`` = 'on' / 'off' forces ``run_cc``.

    :param backend: ``jax.default_backend()`` of the run
    :return: dict with bool ``run_cc`` and ``sort_compact``
    """
    flags = dict(_DEVICE_PATH_DEFAULTS.get(backend,
                                           _DEVICE_PATH_DEFAULTS['cpu']))
    mode = str(settings.get('run cc', 'auto')).strip().lower()
    if mode != 'auto':
        flags['run_cc'] = mode == 'on'
    return flags


def _compact_emissions(emissions, batch_start, frame_offset_valid):
    """(T, S) padded emissions -> column arrays sorted by (frame, id)."""
    mask = np.asarray(emissions['mask'])
    ids = np.asarray(emissions['ids'])
    pos = np.asarray(emissions['pos'])
    info = np.asarray(emissions['info'])
    t_len, s = mask.shape
    frames = np.broadcast_to(np.arange(t_len)[:, None], (t_len, s))
    valid_t = frame_offset_valid[:, None] & mask
    sel = np.nonzero(valid_t)
    if sel[0].size == 0:
        return None
    f = frames[sel] + batch_start
    i = ids[sel]
    order = np.lexsort((i, f))
    out = {
        'TRACK_ID': i[order],
        'POSITION_T': f[order],
        'POSITION_X': pos[sel][order][:, 0].astype(np.float64),
        'POSITION_Y': pos[sel][order][:, 1].astype(np.float64),
        'WIDTH': info[sel][order][:, 0].astype(np.float64),
        'HEIGHT': info[sel][order][:, 1].astype(np.float64),
        'DEGREES_ANGLE': info[sel][order][:, 2].astype(np.float64),
    }
    if pos.shape[-1] > 2:
        out['ILLUMINATION'] = pos[sel][order][:, 2].astype(np.float64)
    return out


def _host_rows_from_packed(packed, counts, k, batch_start,
                           frame_offset_valid, renumberer=None):
    """Rows from the single-buffer device compaction
    (tracker.compact_emissions_device): the first ``counts[t]`` payload
    entries of each frame are the live slots in slot order. Layout per
    payload entry: [id, det_col, pos bits x K, info bits x 3]."""
    b = packed.shape[1] - 1
    ids = packed[:, 1:, 0]
    pos = np.ascontiguousarray(packed[:, 1:, 2:2 + k]).view(np.float32)
    info = np.ascontiguousarray(packed[:, 1:, 2 + k:5 + k]).view(np.float32)
    mask = np.arange(b, dtype=np.int32)[None, :] < counts[:, None]
    if renumberer is not None:
        ids = renumberer.observe_batch(mask, ids, packed[:, 1:, 1],
                                       packed[:, 0, 2], frame_offset_valid)
    return _compact_emissions(
        {'mask': mask, 'ids': ids, 'pos': pos, 'info': info},
        batch_start, frame_offset_valid)


def _renumbered_padded(emissions, frame_valid, renumberer):
    """Padded emissions dict with ids rewritten to the reference's
    registration order (no-op when no renumberer is active)."""
    if renumberer is None or 'det_col' not in emissions:
        return emissions
    emissions = dict(emissions)
    emissions['ids'] = renumberer.observe_batch(
        emissions['mask'], emissions['ids'], emissions['det_col'],
        emissions['n_det'], frame_valid)
    return emissions


def _flight_rows(flight, renumberer=None):
    """Finished column arrays of an in-flight batch: host-tracker flights
    already carry them; device flights compact the padded emissions."""
    em = flight[0]
    if isinstance(em, dict) and 'TRACK_ID' in em:
        return em if len(em['TRACK_ID']) else None
    if isinstance(em, dict) and 'packed' in em:
        packed = np.asarray(em['packed'])
        counts = packed[:, 0, 0]
        if int(counts.max(initial=0)) > packed.shape[1] - 1:
            # bucket overflow (once per upgrade): the padded arrays were
            # kept on device for exactly this batch
            return _compact_emissions(
                _renumbered_padded(
                    {k: np.asarray(v) for k, v in em['padded'].items()},
                    flight[2], renumberer), *flight[1:3])
        return _host_rows_from_packed(packed, counts, em['k'],
                                      flight[1], flight[2],
                                      renumberer=renumberer)
    return _compact_emissions(
        _renumbered_padded({k: np.asarray(v) for k, v in em.items()},
                           flight[2], renumberer), *flight[1:3])


def track_bacteria(video_path, settings=None, result_folder=None):
    """Detect and track bright spots in a video file, save to _list.csv.

    :return: (df, fps, frame_height, frame_width, csv_path) or None on error
    """
    logger = logging.getLogger('ysmr').getChild(__name__)
    settings = get_configs(settings)
    if settings is None:
        logger.critical('No settings provided / could not get settings.')
        return None
    get_loggers(log_level=settings['log_level'],
                logfile_name=settings['log file path'],
                short_stream_output=settings['shorten displayed logging output'],
                short_file_output=settings['shorten logfile logging output'],
                log_to_file=settings['log to file'])
    if not os.path.isfile(video_path):
        logger.critical('File %s does not exist', video_path)
        return None
    try:
        probe_reader = BatchedVideoReader(video_path, batch_size=1)
    except VideoReadError as err:
        logger.exception('Problem opening file %s: %s', video_path, err)
        return None
    frame_bytes = probe_reader.width * probe_reader.height * 3
    transfer_mode = resolve_transfer_mode(settings, frame_bytes)
    display = None
    if settings['display video analysis']:
        from ysmr_tpu.pipeline.display import LiveDisplay
        display = LiveDisplay(video_path, settings, probe_reader.height,
                              probe_reader.width)
        if not display.enabled:
            display = None  # headless: warned already, run normally
    import jax as _jax_mod
    batch_size = resolve_batch_size(settings, transfer_mode,
                                    _jax_mod.default_backend(),
                                    display is not None)
    logger.debug('Transfer mode: %s, batch size: %s', transfer_mode, batch_size)

    frame_count = probe_reader.frame_count
    frame_height, frame_width = probe_reader.height, probe_reader.width
    file_fps = probe_reader.fps
    probe_reader._cap.release()
    if frame_count < settings['minimal frame count']:
        logger.warning('File %s too short; file was skipped. Limit for '
                       "'minimal frame count': %s", video_path,
                       settings['minimal frame count'])
        return None
    if not settings['force tracking.ini fps settings']:
        fps_of_file = file_fps
        if settings['verbose'] or fps_of_file != settings['frames per second']:
            logger.info('fps of file: %s', fps_of_file)
        if not fps_of_file or fps_of_file <= 0:
            if settings['frames per second'] <= 0:
                logger.critical('User defined fps unacceptable: %s',
                                settings['frames per second'])
                return None
            fps_of_file = settings['frames per second']
    else:
        fps_of_file = settings['frames per second']

    if not result_folder:
        result_folder = create_results_folder(video_path)
    logger.info('Starting with file %s', video_path)

    old_list, list_name = save_list(
        path=video_path, result_folder=result_folder, first_call=True,
        rename_old_list=settings['rename previous result .csv'],
        illumination=settings['include luminosity in tracking calculation'])

    if settings['verbose']:
        logger.debug('Frame height: %s, width: %s', frame_height, frame_width)

    config = det.DetectorConfig(settings, fps_of_file)
    import jax as _jax
    path_flags = device_path_flags(settings, _jax.default_backend())
    logger.debug('Device path: %s', path_flags)
    # sparse table CC (ops/labeling.label_components_table) is opt-in: it
    # loses to the whole-frame stencil in end-to-end runs on the CPU
    # (heavy allocator churn in the vmapped gather loops)
    use_table_cc = bool(settings.get('use table cc', False))
    preprocess = None
    if transfer_mode == 'pixels':
        from ysmr_tpu.io.preproc import HostPreprocessor
        preprocess = HostPreprocessor(
            settings, fps_of_file,
            max_fg=settings['max foreground pixels per frame'])
        if display is not None:
            preprocess.keep_frames = True  # retain frames for the preview
    # striped decode pays off only with spare cores; a single decode thread
    # is kept even on one core — it fills the host's DEVICE-WAIT windows
    # (readback transfers) with decode work. 'host decode threads' = 0 opts
    # into inline (threadless) decode.
    raw_threads = int(settings.get('host decode threads', 1) or 0)
    cpu_n = os.cpu_count() or 1
    decode_threads = max(1, min(raw_threads, cpu_n)) if raw_threads > 0 else 1
    decode_threaded = raw_threads > 0
    try:
        reader = BatchedVideoReader(
            video_path, batch_size=batch_size,
            prefetch=settings['prefetch batches'],
            color_filter=settings['color filter'],
            preprocess=preprocess,
            decode_mode=settings.get('decode mode', 'exact'),
            decode_threads=decode_threads,
            threaded=decode_threaded)
    except VideoReadError as err:
        logger.exception('Problem opening file %s: %s', video_path, err)
        return None
    # host-side cv2-bit-exact rect measurement (native/cv2_exact.cpp): the
    # device labels components and returns a per-pixel detection index; the
    # host reproduces cv2.minAreaRect(findContours(...)) to the last float
    # bit from the wire pixels it already holds, and the tracker runs one
    # batch behind detection on the corrected measurements. This removes the
    # ~3e-4 px f32 caliper noise delta vs the reference — the piece that
    # blocks exact TRACK_ID numbering parity (reference track_eval.py:287).
    use_host_rects = False
    # auto-gate on capacity: the host tracker's row-min distance pass is
    # O(slots x dets) serial float64 and the per-detection contour trace
    # runs on the single host core — beyond the threshold (default 1024
    # detections/frame) dense scenes keep the device tracker (documented
    # deviation: double-single arithmetic + renumbered registration order).
    # Raising '[TPU SETTINGS] cv2 exact rects max detections' opts dense
    # scenes into the bit-exact host path (tracker64 is AVX-512 row-min
    # with no materialized matrix, so ~3000x3000 scenes cost only a few
    # ms/frame of host time).
    exact_rect_cap = int(settings.get('cv2 exact rects max detections',
                                      1024) or 0)
    if transfer_mode == 'pixels' and display is None and \
            config.max_det <= exact_rect_cap and \
            bool(settings.get('cv2 exact rects', True)):
        from ysmr_tpu import native as native_mod
        use_host_rects = native_mod.available()
        logger.debug('cv2-exact host rect measurement: %s',
                     'on' if use_host_rects else 'native library missing')
    # device-side bit-exact cv2 CENTERS (ops/cv2_centers.py): when the host
    # rect path is off (native library missing, or 'cv2 exact rects'
    # disabled), the device tracker still consumes cv2.minAreaRect's f32
    # caliper center bit-for-bit — removing the dominant measurement-noise
    # delta that flips near-tie greedy assignments (the W/H/angle columns
    # keep the exact decomposition; remaining id deviations are the
    # double-single GSFF residue, see tracker.py). Gather-free it costs
    # <1 ms/frame even at 4096-detection capacity (dense 3000-rod clip:
    # ~58 fps either way, 2893 -> 2895 of 2899 reference-identical track
    # ids), so 'auto' enables it whenever the device tracker measures.
    cv2c_mode = str(settings.get('cv2 exact centers', 'auto')).strip().lower()
    use_cv2_centers = (not use_host_rects) and cv2c_mode != 'off'
    # run-length wire: raster-order foreground pixels form horizontal runs,
    # so RLE cuts the dominant host->device transfer ~4-5x at dense scale
    # (native encode_runs_batch / numpy fallback; expanded back to the
    # identical pixel table on device). The 26-bit run-start field caps the
    # frame size; 'wire format = pixels' opts out.
    wire_format = str(settings.get('wire format', 'auto')).lower()
    use_runs_wire = (transfer_mode == 'pixels' and wire_format != 'pixels'
                     and frame_height * frame_width < (1 << 26))
    # run-graph CC (ops/run_cc.py): label directly on the run tables instead
    # of rasterizing + stencil-labeling whole frames (device_path_flags)
    use_run_cc = use_runs_wire and path_flags['run_cc']
    runs_buf = runs_cnt = None
    runs_bucket = 512

    def encode_wire_runs(packed_np, counts_np):
        """Encode one batch's packed wire as runs; None -> pixel wire."""
        nonlocal runs_buf, runs_cnt, runs_bucket
        from ysmr_tpu import native as nat
        b, fcap = packed_np.shape
        if runs_buf is None or runs_buf.shape != (b, fcap):
            runs_buf = np.zeros((b, fcap), np.uint32)
            runs_cnt = np.zeros(b, np.int32)
        ret = nat.encode_runs_batch(packed_np, counts_np, runs_buf, runs_cnt,
                                    w=frame_width)
        if ret is None:
            ret = nat.encode_runs_numpy(packed_np, counts_np, runs_buf,
                                        runs_cnt, w=frame_width)
        if ret is None or ret < 0:
            return None
        if ret > runs_bucket:
            runs_bucket = min(fcap, _next_pow2(int(ret)))
        # the buffers are reused next batch while this batch's transfer may
        # still be in flight — hand jit its own copies
        return {'px_runs': runs_buf[:, :runs_bucket].copy(),
                'run_counts': runs_cnt.copy(), 'expanded_f': fcap}
    use_gsff = not settings['disable gsff']
    dims = 3 if config.include_luminosity else 2
    max_slots = settings['max track slots']
    tracker_kwargs = dict(max_disappeared=float(fps_of_file), use_gsff=use_gsff)
    # dense-scene assignment sharding ([TPU SETTINGS] 'shard dense
    # assignment across devices', SURVEY.md section 2.2(c)): row-shard the
    # tracker's slots x detections distance matrix over the device mesh.
    # Engaged only when a multi-device mesh is visible AND the padded
    # matrix reaches the threshold — below it the matrix fits one device
    # and the collective would be pure overhead.
    if bool(settings.get('shard dense assignment across devices', False)):
        n_dev = len(_jax.devices())
        big_enough = max_slots * config.max_det >= int(
            settings.get('dense assignment shard threshold', 1 << 21))
        if n_dev > 1 and big_enough and max_slots % n_dev == 0:
            from ysmr_tpu.parallel.sharding import make_mesh
            tracker_kwargs['assign_mesh'] = make_mesh(axis='slots')
            logger.debug('Dense assignment row-sharded over %d devices',
                         n_dev)
    if use_gsff:
        params = gsff_ops.GSFFParams(
            fps=fps_of_file,
            n_min=settings['minimum horizon size'],
            n_max=settings['maximum horizon size'],
            n_f=settings['number of LSFFs'])
        state = trk.init_tracker_state(max_slots, dims=dims, use_gsff=True,
                                       gsff_params=params)
        tracker_kwargs.update(gsff_gains=params.gains, gsff_n_i=params.n_i_arr,
                              gsff_n_f=params.n_f, gsff_n_i0=params.n_i[0])
    else:
        state = trk.init_tracker_state(max_slots, dims=dims)

    threshold_state = pp.MovingAverageThreshold(
        fps=fps_of_file, offset=config.offset,
        white_on_dark=config.white_on_dark) if config.mode == 'mean' else None

    # float64 host tracker (native/tracker64.cpp): in host-rect mode the
    # tracker itself also runs on the host, in the reference's float64
    # arithmetic — TRACK_ID numbering and filtered positions become
    # reference-identical (the device filter bank's double-single f32
    # residual can flip near-tie greedy matches at GSFF mode transitions),
    # and the emissions readback disappears entirely. The device tracker
    # remains for frames mode, luminosity+GSFF (a combination the
    # reference's float64 tracker cannot run at all), dense scenes, and the
    # sharded multi-video path.
    native_tracker = None
    if use_host_rects and not (config.include_luminosity and use_gsff):
        try:
            native_tracker = native_mod.Tracker64(
                dims=dims, max_disappeared=float(fps_of_file),
                gsff_params=params if use_gsff else None)
        except RuntimeError:
            native_tracker = None
    # device-tracker modes rewrite TRACK_IDs at readback into the
    # reference's CPython-set registration order (ReferenceOrderRenumberer);
    # the float64 host tracker already registers in that order itself
    renumberer = None if native_tracker is not None else \
        trk.ReferenceOrderRenumberer()

    import time
    profiler_dir = settings.get('jax profiler dir') or ''

    def stop_profiler():
        if not profiler_dir:
            return
        import jax.profiler
        try:
            jax.profiler.stop_trace()
            logger.info('jax profiler trace written to %s', profiler_dir)
        except RuntimeError:
            pass  # already stopped

    if profiler_dir:
        # device-level tracing on top of the 'profile stages' wall-clock
        # split (SURVEY.md section 5: the reference only has a per-frame fps
        # timer; here the full XLA timeline comes from the jax profiler)
        import jax.profiler
        os.makedirs(profiler_dir, exist_ok=True)
        try:
            jax.profiler.start_trace(profiler_dir)
        except RuntimeError as err:
            logger.warning('jax profiler not started: %s', err)
            profiler_dir = ''
    t_start = time.perf_counter()
    pending = []  # accumulated column arrays awaiting flush
    # every compacted part, kept for the in-memory final sort — bounded:
    # beyond ~16M rows (~1 GB of column arrays) the final sort falls back to
    # the CSV round-trip instead of holding the whole run in memory
    all_parts = []
    all_parts_rows = 0
    max_in_memory_rows = 1 << 24
    pending_rows = 0
    flush_every = settings['list save length interval']
    error_during_read = False
    frames_processed = 0
    overflow_warned = False
    # one-batch delay on ALL device readback (emissions + detection counts):
    # fetching immediately would block the host on the device compute of the
    # current batch and stall the single-core decode thread; one batch later
    # the values are long since ready and the fetch costs only the transfer
    in_flight = None  # (emissions, start, frame_valid, n_components, disp)
    # host-rect mode runs the tracker one batch behind detection:
    # detect(i) dispatch -> [decode i+1 overlaps] -> det_px(i) readback ->
    # host cv2-exact rects(i) -> tracker(i) dispatch -> emissions(i) readback
    # one batch later still. pending_det holds the detected-not-yet-tracked
    # batch; trk_d is the tracker's detection-slot width (small bucket first,
    # upgraded once to max_det if a frame ever exceeds it).
    pending_det = None
    trk_d = min(config.max_det, 128)
    # pipelined host-rect tail: with the float64 host tracker active the
    # rects+tracker work has no device dependency, so it runs on worker
    # threads chained in batch order (YSMR_RECT_WORKER=0 opts back into the
    # inline tail)
    rect_worker_enabled = (
        use_host_rects and native_tracker is not None and
        not config.include_luminosity and
        os.environ.get('YSMR_RECT_WORKER', '1') != '0')
    prev_rect_worker = {'thread': None}

    def stage_host_rect_detect(tables, data, count, start, fv,
                               runs_args=None):
        """Queue a detected batch for the host rect stage: slice the
        detection-index readback to the batch's bucket, start its async
        fetch, keep the host-side wire pixels. With the runs wire the
        device ships ONE det index per RUN (det_run_idx, ~5x fewer bytes);
        the host expands it against the run table it already holds."""
        det_run_dev = tables.pop('det_run_idx', None)
        counts_np = np.asarray(data['count'])
        if det_run_dev is not None:
            rc_np = runs_args['run_counts']
            bucket = min(det_run_dev.shape[1],
                         max(64, _next_pow2(int(rc_np.max()) if count else 1)))
            det_px_dev = _slice_cols_with_counts(bucket)(
                det_run_dev, tables['n_components'])
            run_expand = (runs_args['px_runs'], rc_np,
                          min(data['px_packed'].shape[1],
                              max(256, _next_pow2(
                                  int(counts_np.max()) if count else 1))))
        else:
            det_px_dev = tables.pop('det_px_idx')
            run_expand = None
            f_bucket = min(det_px_dev.shape[1],
                           max(256,
                               _next_pow2(int(counts_np.max()) if count else 1)))
            # n_components rides the same buffer as an extra int16 column:
            # the consume side then pays ONE fetch per batch instead of two
            det_px_dev = _slice_cols_with_counts(f_bucket)(
                det_px_dev, tables['n_components'])
        packed_np = data.get('px_packed')
        if packed_np is None:  # split-coordinate wire format (luminosity)
            packed_np = (data['px_y'].astype(np.uint32) *
                         np.uint32(frame_width) +
                         data['px_x'].astype(np.uint32))
        try:
            det_px_dev.copy_to_host_async()
        except AttributeError:
            pass
        # materialize the fetch on a helper thread: the wait is pure IO (the
        # GIL is released inside the transfer), so pushing it off the
        # consumer thread lets the decode thread fill that window
        fetch = {'arr': None}

        def _fetch():
            fetch['arr'] = np.asarray(det_px_dev)

        fetch_thread = threading.Thread(target=_fetch, daemon=True)
        fetch_thread.start()
        gray_dev = None
        if config.include_luminosity:
            # stage the gray planes for the rect-luminosity pass that runs
            # at tracker time against the HOST rects (_det_xy_with_rect_lum)
            gray_dev = _jax.device_put(np.ascontiguousarray(data['gray']))
        pending = {'det_px': det_px_dev, 'packed': packed_np,
                   'counts': counts_np, 'start': start, 'frame_valid': fv,
                   'gray_dev': gray_dev, 'fetch': fetch,
                   'fetch_thread': fetch_thread, 'run_expand': run_expand}
        if rect_worker_enabled:
            # run the whole rects -> float64-tracker tail on a worker
            # thread chained to the previous batch's worker (the tracker is
            # sequential): its native sections release the GIL and timeshare
            # with decode instead of serializing in the consumer loop
            result = {}
            prev = prev_rect_worker['thread']

            def _work():
                if prev is not None:
                    prev.join()
                try:
                    result['flight'] = run_host_rect_tracker(pending)
                except BaseException as exc:  # re-raised at consume time
                    result['error'] = exc

            worker = threading.Thread(target=_work, daemon=True)
            pending['worker'] = worker
            pending['result'] = result
            prev_rect_worker['thread'] = worker
            worker.start()
        return pending

    def finish_host_rect(pending):
        """Flight for a staged batch: with the pipelined tail active the
        worker is NOT joined here — the lazy flight is resolved by
        consume_flight one batch later, giving the worker a full extra
        batch period to finish before anyone blocks on it (the join wait
        here measured 0.13-0.15 ms/frame of pure scheduling lag)."""
        worker = pending.get('worker')
        if worker is None:
            return run_host_rect_tracker(pending)
        return ('lazy_rect_flight', pending)

    def resolve_lazy_flight(flight):
        """Join a deferred rect-worker flight; pass-through otherwise."""
        if not (isinstance(flight, tuple) and len(flight) == 2 and
                flight[0] == 'lazy_rect_flight'):
            return flight
        pending = flight[1]
        t0 = time.perf_counter()
        pending['worker'].join()
        # the worker already books its own det_readback (fetch-join) time;
        # the consumer's join wait is a DIFFERENT quantity (how long the
        # pipelined tail lagged the consumer) and overlaps the worker's
        # interval, so it gets its own key (ADVICE r3: double counting)
        with stage_lock:
            stage_t['rect_worker_wait'] += time.perf_counter() - t0
        if 'error' in pending['result']:
            raise pending['result']['error']
        return pending['result']['flight']

    def run_host_rect_tracker(pending):
        """cv2-bit-exact rects on the host for a read-back batch, then the
        tracker scan on the corrected measurements; returns the flight tuple
        for the delayed emissions readback."""
        nonlocal state, trk_d
        t_a = time.perf_counter()
        pending['fetch_thread'].join()
        fused = pending['fetch']['arr']
        if fused is None:  # fetch thread died; fall back to a direct fetch
            fused = np.asarray(pending['det_px'])
        det_px = fused[:, :-1]
        n_comp = fused[:, -1].astype(np.int32)
        if pending['run_expand'] is not None:
            px_runs_np, rc_np, f_bucket = pending['run_expand']
            expanded = native_mod.expand_run_det(px_runs_np, rc_np, det_px,
                                                 f_bucket)
            det_px = expanded if expanded is not None else \
                _expand_run_det(px_runs_np, rc_np, det_px, f_bucket)
        fv = pending['frame_valid']
        max_n = int(n_comp[fv].max()) if fv.any() else 0
        if max_n > trk_d:
            trk_d = config.max_det  # one recompile of the scan, then stable
        packed = np.ascontiguousarray(pending['packed'][:, :det_px.shape[1]])
        counts = np.where(fv, pending['counts'], 0).astype(np.int32)
        t_b = time.perf_counter()
        with stage_lock:
            stage_t['det_readback'] += t_b - t_a
        rects, rvalid = native_mod.cv2_rects_batch(
            packed, counts, det_px, frame_width, trk_d)
        t_c = time.perf_counter()
        with stage_lock:
            stage_t['rects'] += t_c - t_b
        rects = np.where(rvalid[..., None], rects, np.float32(0))
        lum_np = None
        if config.include_luminosity:
            det_xy_dev = _det_xy_with_rect_lum(pending['gray_dev'], rects,
                                               rvalid, config.lum_win)
            if native_tracker is not None:
                lum_np = np.asarray(det_xy_dev)[:, :, 2]
        if native_tracker is not None:
            t_count = int(fv.sum())
            out = native_tracker.update_batch(
                rects[:t_count], rvalid[:t_count], frame0=pending['start'],
                lum=lum_np[:t_count] if lum_np is not None else None)
            with stage_lock:
                stage_t['tracker'] += time.perf_counter() - t_c
            # n_comp is already on host — carrying the device array would
            # cost consume_flight a fresh fetch per batch
            return (out, pending['start'], fv, n_comp, None)
        if config.include_luminosity:
            det_xy = det_xy_dev
        else:
            det_xy = np.ascontiguousarray(rects[:, :, :2])
        new_state, emissions = trk.run_tracker_scan(
            state, det_xy,
            np.ascontiguousarray(rects[:, :, 2:5]), rvalid, **tracker_kwargs)
        state = new_state
        # n_comp is already host-side (it rode the det_px buffer), so the
        # flight's overflow check costs no extra fetch here either
        return emit_device_flight(emissions, pending['start'], fv,
                                  n_comp, None)

    def start_async_readback(emissions, n_components):
        for arr in (*emissions.values(), n_components):
            try:
                arr.copy_to_host_async()
            except AttributeError:
                pass

    # device-emissions readback compaction: live slots are packed to the
    # front on device (cumsum-rank scatter) so the host fetches
    # (T, em_bucket) instead of (T, max_slots) — at dense capacities the
    # padded readback is ~6.5 MB/batch of mostly-dead slots and dominates
    # the d2h wire. The bucket grows to the next power of two past the
    # largest observed live count (one recompile per upgrade; the padded
    # arrays cover the upgrading batch). Display mode keeps the padded
    # arrays (the preview reads them directly).
    compact_readback = (display is None and not _FORCE_PADDED_READBACK
                        and bool(settings.get('compact emissions readback',
                                              False)))
    em_bucket = min(1024, max_slots)

    def emit_device_flight(emissions, start, fv, n_components, disp):
        if not compact_readback:
            start_async_readback(emissions, n_components)
            return (emissions, start, fv, n_components, disp)
        packed = trk.compact_emissions_device(emissions, n_components,
                                              bucket=em_bucket)
        try:
            packed.copy_to_host_async()
        except AttributeError:
            pass
        return ({'packed': packed, 'k': int(emissions['pos'].shape[-1]),
                 'padded': emissions}, start, fv, n_components, disp)

    def consume_flight(flight):
        """Row extraction + overflow bookkeeping for a finished flight.

        Compacted device flights cost exactly ONE host fetch here (each
        fetch pays the link's latency): counts, n_components,
        ids, positions, and side info all ride the packed buffer. The
        emissions bucket grows past the largest observed live count; the
        upgrading batch falls back to its padded arrays (_flight_rows).
        """
        nonlocal em_bucket
        flight = resolve_lazy_flight(flight)
        em = flight[0]
        if isinstance(em, dict) and 'packed' in em:
            packed = np.asarray(em['packed'])
            counts = packed[:, 0, 0]
            check_overflow(packed[:, 0, 1], flight[2])
            cmax = int(counts.max(initial=0))
            if cmax > em_bucket:
                em_bucket = min(max_slots, _next_pow2(cmax))
            if cmax > packed.shape[1] - 1:
                return _compact_emissions(
                    _renumbered_padded(
                        {k: np.asarray(v) for k, v in em['padded'].items()},
                        flight[2], renumberer), *flight[1:3])
            return _host_rows_from_packed(packed, counts, em['k'],
                                          flight[1], flight[2],
                                          renumberer=renumberer)
        check_overflow(flight[3], flight[2])
        return _flight_rows(flight, renumberer=renumberer)

    def check_overflow(n_components, frame_valid):
        nonlocal overflow_warned
        if overflow_warned:
            return
        n_comp = np.asarray(n_components)
        if (n_comp[frame_valid] > config.max_det).any():
            overflow_warned = True
            logger.warning(
                'Frame(s) with more than %s detections; extra components '
                "dropped. Raise 'max detections per frame' in [TPU "
                'SETTINGS].', config.max_det)

    def maybe_display(flight):
        """Preview a read-back batch; returns True when the user hit 'q'."""
        # lazy rect-worker flights are 2-tuples ('lazy_rect_flight', pending)
        # until consume_flight joins the worker; host-rect flights carry
        # disp=None anyway, so skip without resolving (indexing flight[4]
        # here crashed display-enabled host-rect runs)
        if isinstance(flight, tuple) and len(flight) == 2 and \
                flight[0] == 'lazy_rect_flight':
            return display is not None and display.interrupted
        if display is None or flight[4] is None or not display.enabled or \
                display.interrupted:
            return display is not None and display.interrupted
        disp = flight[4]
        det_host = {k: np.asarray(v) for k, v in disp['det'].items()}
        if disp.get('px') is not None:
            for key in ('px_x', 'px_y', 'px_marker', 'px_packed', 'count'):
                if key in disp['px']:
                    det_host[key] = np.asarray(disp['px'][key])
        emis_host = {k: np.asarray(flight[0][k])
                     for k in ('mask', 'ids', 'pos')}
        cur_fps = frames_processed / max(time.perf_counter() - t_start, 1e-9)
        display.show_batch(disp['frames'], int(flight[2].sum()), det_host,
                           emis_host, cur_fps)
        return display.interrupted

    def flush():
        nonlocal pending, pending_rows
        if not pending:
            return
        arrays = {k: np.concatenate([p[k] for p in pending]) for k in pending[0]}
        save_list(arrays=arrays, path=list_name,
                  illumination=config.include_luminosity)
        pending = []
        pending_rows = 0

    stage_t = {'wait_batch': 0.0, 'dispatch': 0.0, 'readback': 0.0,
               'csv': 0.0, 'det_readback': 0.0, 'rects': 0.0, 'tracker': 0.0,
               'rect_worker_wait': 0.0}
    # worker threads (rect/tracker tail) and the consumer update stage_t
    # concurrently; += on a dict entry is not atomic under the GIL's
    # bytecode boundaries
    stage_lock = threading.Lock()
    try:
        batches = iter(reader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                break
            t1 = time.perf_counter()
            stage_t['wait_batch'] += t1 - t0
            data = batch['frames']
            count = batch['count']
            frame_valid = np.zeros((batch_size,), bool)
            frame_valid[:count] = True
            if transfer_mode == 'pixels':
                from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels
                # ship the compact wire format (int16/uint8); widening and
                # validity masks happen on device
                runs_args = {}
                if use_runs_wire and data.get('px_packed') is not None and \
                        'px_gray' not in data:
                    runs_args = encode_wire_runs(data['px_packed'],
                                                 data['count']) or {}
                tables = detect_from_pixels(
                    data.get('px_x'), data.get('px_y'), data['count'],
                    data.get('px_marker'), frame_valid,
                    px_packed=None if runs_args else data.get('px_packed'),
                    **runs_args,
                    h=frame_height, w=frame_width,
                    double_threshold=(config.mode == 'adaptive_double'),
                    max_det=config.max_det, max_bh=config.max_bh,
                    cc_iters=config.cc_iters,
                    # in host-rect mode the device pass is labels-only; the
                    # rect luminosity runs at tracker time on the host rects
                    include_luminosity=config.include_luminosity
                    and not use_host_rects,
                    gray_frames=data.get('gray')
                    if config.include_luminosity and not use_host_rects
                    else None,
                    lum_win=config.lum_win,
                    px_gray=data['px_gray']
                    if config.include_luminosity and not use_host_rects
                    and 'px_gray' in data else None,
                    sort_compact=path_flags['sort_compact'],
                    use_table=use_table_cc,
                    return_det_px=use_host_rects, skip_rect=use_host_rects,
                    use_run_cc=use_run_cc,
                    det_px_as_runs=use_host_rects and use_run_cc
                    and bool(runs_args),
                    cv2_centers=use_cv2_centers)
            else:
                tables = det.detect_batch(data, frame_valid, config,
                                          threshold_state=threshold_state)
            if use_host_rects:
                pending_next = stage_host_rect_detect(
                    tables, data, count, batch['start'], frame_valid,
                    runs_args or None)
                new_flight = None
                if pending_det is not None:
                    new_flight = finish_host_rect(pending_det)
                pending_det = pending_next
            else:
                state, emissions = trk.run_tracker_scan(
                    state, tables['det_xy'], tables['det_info'],
                    tables['det_valid'], **tracker_kwargs)
            t2 = time.perf_counter()
            stage_t['dispatch'] += t2 - t1
            disp = None
            if display is not None and display.enabled and \
                    not display.interrupted:
                disp = {'det': {k: tables[k] for k in
                                ('det_xy', 'det_info', 'det_valid')}}
                if transfer_mode == 'pixels':
                    disp['frames'] = data.get('display_frames')
                    disp['px'] = data
                else:
                    disp['frames'] = data
            csv_this_iter = 0.0
            frames_processed += count
            if not use_host_rects:
                new_flight = emit_device_flight(
                    emissions, batch['start'], frame_valid,
                    tables['n_components'], disp)
            if new_flight is not None:
                if in_flight is not None:
                    if maybe_display(in_flight):
                        logger.error('Processing file interrupted by user: %s',
                                     video_path)
                        error_during_read = True
                        break
                    out = consume_flight(in_flight)
                    if out is not None:
                        pending.append(out)
                        if all_parts is not None:
                            all_parts.append(out)
                            all_parts_rows += len(out['TRACK_ID'])
                            if all_parts_rows > max_in_memory_rows:
                                all_parts = None  # too big; sort from CSV at end
                        pending_rows += len(out['TRACK_ID'])
                        if pending_rows >= flush_every:
                            t3 = time.perf_counter()
                            flush()
                            csv_this_iter = time.perf_counter() - t3
                            stage_t['csv'] += csv_this_iter
                in_flight = new_flight
            stage_t['readback'] += (time.perf_counter() - t2) - csv_this_iter
    except VideoReadError:
        logger.critical('Error during read with file %s', video_path)
        error_during_read = settings['stop evaluation on error']
    if use_host_rects and pending_det is not None and not error_during_read:
        # drain the detect->rect->track pipeline: consume the current flight,
        # then track the final detected batch
        if in_flight is not None:
            out = consume_flight(in_flight)
            if out is not None:
                pending.append(out)
                if all_parts is not None:
                    all_parts.append(out)
                pending_rows += len(out['TRACK_ID'])
        in_flight = finish_host_rect(pending_det)
    if in_flight is not None and not error_during_read:
        if maybe_display(in_flight):
            logger.error('Processing file interrupted by user: %s', video_path)
            error_during_read = True
    if in_flight is not None and not error_during_read:
        out = consume_flight(in_flight)
        if out is not None:
            pending.append(out)
            if all_parts is not None:
                all_parts.append(out)
            pending_rows += len(out['TRACK_ID'])
    flush()
    if display is not None:
        display.close()
    if preprocess is not None and preprocess.overflowed:
        logger.warning(
            '%s frame(s) exceeded %s foreground pixels; extra pixels dropped. '
            "Raise 'max foreground pixels per frame' in [TPU SETTINGS].",
            preprocess.overflowed, preprocess.max_fg)

    # the float64 host tracker has no slot cap (tracks are unbounded, as in
    # the reference), so nothing can be dropped there
    dropped = 0 if native_tracker is not None else \
        int(np.asarray(state['dropped_registrations']))
    if dropped:
        logger.warning('%s registrations dropped (track slot capacity %s '
                       "reached); raise 'max track slots' in [TPU SETTINGS].",
                       dropped, max_slots)

    if old_list and error_during_read:
        try:
            os.remove(list_name)
            os.rename(old_list, list_name)
            logger.info('Restoring old list: %s', list_name)
        except (OSError, FileNotFoundError) as file_removal_error:
            logger.error('Error restoring %s: %r', list_name,
                         file_removal_error.args)

    last_object_id = (native_tracker.next_id if native_tracker is not None
                      else int(np.asarray(state['next_id']))) - 1
    if last_object_id < 0:
        stop_profiler()
        logger.warning('Did not track any objects. File: %s', video_path)
        return None

    save_sorted = not settings['delete .csv file after analysis']
    if all_parts and not error_during_read:
        # rows are still in memory: sort + rewrite without the CSV round-trip
        df_for_eval = finalize_sorted_list(
            all_parts, list_name, illumination=config.include_luminosity,
            save_file=save_sorted)
    else:
        df_for_eval = sort_list(file_path=list_name, save_file=save_sorted)
    elapsed = time.perf_counter() - t_start
    stop_profiler()
    analysis_fps = frames_processed / elapsed if elapsed > 0 else float('inf')
    if frames_processed:
        global LAST_STAGE_SPLIT
        LAST_STAGE_SPLIT = {
            k: round(v / frames_processed * 1e3, 3) for k, v in stage_t.items()}
        LAST_STAGE_SPLIT['total_ms_per_frame'] = round(
            elapsed / frames_processed * 1e3, 3)
    if (settings['verbose'] or settings.get('profile stages')) and frames_processed:
        extra = ''
        if stage_t['rects'] or stage_t['tracker']:
            # the host-rect sub-stages are inside the dispatch bucket
            extra = (' [det_readback %.2f, rects %.2f, tracker %.2f, '
                     'tail_wait %.2f]' % (
                         stage_t['det_readback'] / frames_processed * 1e3,
                         stage_t['rects'] / frames_processed * 1e3,
                         stage_t['tracker'] / frames_processed * 1e3,
                         stage_t['rect_worker_wait'] / frames_processed
                         * 1e3))
        logger.info(
            'Per-frame stage times: wait_batch %.2f ms, dispatch %.2f ms%s, '
            'readback %.2f ms, csv %.2f ms (of %.2f ms total)',
            stage_t['wait_batch'] / frames_processed * 1e3,
            stage_t['dispatch'] / frames_processed * 1e3, extra,
            stage_t['readback'] / frames_processed * 1e3,
            stage_t['csv'] / frames_processed * 1e3,
            elapsed / frames_processed * 1e3)
    logger.info(
        'Average frames analysed per second: %s, objects: %s, frames: %s, csv: %s',
        '{:.2f}'.format(analysis_fps).rjust(6, ' '),
        '{}'.format(last_object_id + 1).rjust(6, ' '),
        '{:>6} of {:>6}'.format(frames_processed, frame_count),
        list_name)

    if error_during_read:
        logger.critical('Error during read, stopping before evaluation. '
                        'File: %s', video_path)
        return None
    return df_for_eval, fps_of_file, frame_height, frame_width, list_name
