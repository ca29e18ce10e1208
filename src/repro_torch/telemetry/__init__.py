"""Observability of the port (``repro.telemetry``'s counterpart): one
metrics and tracing tier for serving and training.

Layout
------
``metrics``   Counter / Gauge / fixed-bucket Histogram, MetricsRegistry
              (snapshot + Prometheus text), validate_snapshot, clocks.
``tracing``   annotate (profiler spans), maybe_profile (REPRO_PROFILE_DIR
              capture), JsonlSink / ListSink, RequestTracer and fault_hook
              (serving lifecycle), TrainTracer (training lifecycle).
``probes``    QAT health probes: an ambient collector that forward-pass tap
              sites record into, the param-side probes and the cadenced
              democratization snapshot.

Metric name registry
--------------------
One namespace across the codebase; names are stable and match the JAX
package's, so dashboards and artifacts key on them.  Prometheus-safe
(``[a-zA-Z_][a-zA-Z0-9_]*``).

Serving (wired by the engines, the scheduler and kv_pool):
  ``requests_submitted_total`` / ``requests_finished_total{reason=...}``
  ``tokens_generated_total``, ``prefill_chunks_total``, ``decode_chunks_total``
  ``queue_depth``, ``batch_occupancy``, ``pool_blocks_used``
  ``ttft_seconds``, ``itl_seconds``, ``request_latency_seconds``
  ``prefix_cache_{hits,misses,hit_tokens,cow,evictions}_total``

Training (wired by ``repro_torch.train.trainer.Trainer``):
  counters   ``train_steps_total``, ``train_recoveries_total``,
             ``train_restores_total``, ``train_checkpoints_total``
  gauges     ``train_loss``, ``train_nll``, ``train_lr``, ``train_wd``,
             ``train_grad_norm``, ``train_step`` (latest step id)
  histogram  ``train_step_seconds``

QAT health probes (join the per-step metrics when
``TrainerConfig.probes`` is on; all computed on the device inside
``train_step``, and they come to the host in the step's one transfer):
  ``qat_flip_attn`` / ``qat_flip_ffn1`` / ``qat_flip_ffn8`` /
  ``qat_flip_embed``        latent-weight sign-flip rate against the
                            previous step, per layer family (centered
                            sign, matching the AbsMean binarizer)
  ``qat_clip_w8``           INT8-branch weight saturation rate (|q|=127)
  ``qat_clip_act``          INT8 activation saturation rate across every
                            act-quant site in the forward
  ``qat_scale_drift_absmean`` / ``qat_scale_drift_absmax``
                            relative per-step drift of the 1-bit AbsMean
                            scales (lambda) / 8-bit AbsMax scales
  ``qat_branch_share8``     fraction of decoupled-layer output norm
                            carried by the 8-bit branch (alpha*y8) against
                            the 1-bit trunk (beta*y1): the paper's
                            allocation claim, live
  ``qat_gnorm_ffn8`` / ``qat_gnorm_ffn1`` / ``qat_gnorm_share8``
                            per-branch gradient-norm split
  ``qat_router_entropy``    routed-expert load entropy (N > 1 only):
                            normalized entropy of the top-1 fractions,
                            1 balanced, 0 collapsed, averaged over every
                            router of the forward

Cadenced democratization snapshot (every
``TrainerConfig.sensitivity_every`` steps, between steps; reuses
``core.sensitivity``): ``demo_score_<fam>``, ``demo_kurtosis_<fam>``,
``demo_top1pct_<fam>`` for ``fam`` in attn / ffn1 / ffn8.

Reading a train trace
---------------------
``TrainerConfig.trace_path`` streams the run lifecycle as JSONL (one
compact object a line, flushed an event: a crash leaves a replayable
prefix).  Events, all carrying ``{"t": run-relative seconds, "event":
..., "step": ...}``:

  ``run_start``    config digest: arch name, quant mode, total steps
  ``step``         per-step record: loss/nll/lr/grad_norm, every qat_*
                   probe and, on the snapshot's cadence, the demo_* keys;
                   the JSONL twin of the history record
  ``checkpoint``   checkpoint save issued at ``step``
  ``restore``      state restored from ``from_step`` (startup resume)
  ``recovery``     auto-recovery: non-finite loss at ``step``, rolled
                   back to ``from_step``; ``recoveries`` = running count
  ``heartbeat``    liveness mark at ``log_every`` cadence
  ``run_end``      final step + total recoveries

A minimal reader::

    import json
    events = [json.loads(l) for l in open("train_trace.jsonl")]
    steps = [e for e in events if e["event"] == "step"]
    flips = [e.get("qat_flip_ffn1") for e in steps]

Healthy pQuant runs show ``qat_flip_*`` decaying toward 0 as latents
settle, ``qat_branch_share8`` well above 0 (the 8-bit branch is carrying
signal: democratization is being broken), and ``qat_clip_act`` low;
spikes in ``qat_scale_drift_*`` precede the loss spikes that trigger
``recovery`` events (paper Fig. 10).

What makes all of this free: with telemetry off (``probes=False``, no
tracer or registry attached) the training step launches the same torch
operations as a bare ``make_train_step``, and the Trainer adds one host
sync a step, the metrics' transfer (pinned by
``tests/test_torch_trainer.py``).
"""
