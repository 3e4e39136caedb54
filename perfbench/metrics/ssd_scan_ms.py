"""ssd_scan_ms: device time of the Mamba-2 layers' chunked scan, ms a
step: the forwards, re-runs and backward nodes of the program's
``ssm.scan`` span (``models/ssm.py`` ``ssd_chunked``) in the traced run's
span pass; nothing where no scan ran."""


def read(rec):
    spans = rec.get("spans")
    row = spans["spans"].get("ssm.scan") if spans else None
    if not row:
        return None
    return (row["device_ms"] + row["bwd_device_ms"]) / spans["steps"]
