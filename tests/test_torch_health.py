"""The port's health plane (``util/health.py``: SLO burn rates, alerts,
the proxy's shed advisory) held to the JAX package's own tests.

``tests/test_zz_health.py`` runs here unedited (``_torch_ported.py``,
``ray_tpu`` rewritten to ``ray_tpu_torch``, no other rename). Left out,
each for the ROADMAP.md Queue 1 item it waits for:

- test_ttft_degradation_fires_page_alert_with_trace_e2e and
  test_worker_pushed_series_reach_head_store_e2e: item 17 (their
  clusters serve the metrics HTTP endpoint, ``metrics_port=0``);
- test_health_json_param_parsed_not_substring_matched: item 17 (the
  endpoint's ``_wants_json``);
- test_cli_health_and_metrics_query: item 17 (the ``scripts.py`` CLI's
  ``_call_head``).
"""

from _torch_ported import adopt, ported

SKIP = {
    "test_ttft_degradation_fires_page_alert_with_trace_e2e":
        "Queue 1 item 17: the metrics HTTP endpoint (metrics_port=0)",
    "test_worker_pushed_series_reach_head_store_e2e":
        "Queue 1 item 17: the metrics HTTP endpoint (metrics_port=0)",
    "test_health_json_param_parsed_not_substring_matched":
        "Queue 1 item 17: the metrics HTTP endpoint's _wants_json",
    "test_cli_health_and_metrics_query":
        "Queue 1 item 17: the scripts.py CLI",
}

adopt(ported("test_zz_health"), globals(), skip=SKIP)
