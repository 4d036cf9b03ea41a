"""Self time of ``Localizer.process_data`` per call, the loop closer's
(``process_vertex``) and the optimizer's (``process_data``) spans inside
it left out; over the span-timed part of a traced window."""


def read(run):
    s = run.spans
    if s is None or not s.calls.get("frontend"):
        return None
    return 1e3 * s.self_s["frontend"] / s.calls["frontend"]
