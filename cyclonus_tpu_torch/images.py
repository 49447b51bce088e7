"""Container image defaults, env-overridable — the single source of truth
(probe pod specs and kubectl manifests read these).

The reference pins k8s.gcr.io/e2e-test-images/agnhost:2.28 (pod.go:13-16);
k8s.gcr.io froze in 2023, registry.k8s.io serves the same artifacts.
"""

import os

AGNHOST_IMAGE = os.environ.get(
    "CYCLONUS_AGNHOST_IMAGE", "registry.k8s.io/e2e-test-images/agnhost:2.28"
)
WORKER_IMAGE = os.environ.get("CYCLONUS_WORKER_IMAGE", "cyclonus-tpu-worker:latest")
