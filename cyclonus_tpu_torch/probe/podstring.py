"""'ns/pod' key type and wildcard peer matching
(reference: probe/podstring.go)."""

from __future__ import annotations

from dataclasses import dataclass


class PodString(str):
    """A 'namespace/pod' key."""

    @staticmethod
    def make(namespace: str, pod_name: str) -> "PodString":
        return PodString(f"{namespace}/{pod_name}")

    def _split(self):
        pieces = self.split("/")
        if len(pieces) != 2:
            raise ValueError(f"expected ns/pod, found {pieces}")
        return pieces[0], pieces[1]

    @property
    def namespace(self) -> str:
        return self._split()[0]

    @property
    def pod_name(self) -> str:
        return self._split()[1]


@dataclass
class Peer:
    """Wildcard pod matcher: empty namespace/pod matches everything
    (podstring.go:43-54)."""

    namespace: str = ""
    pod: str = ""

    def matches(self, pod: PodString) -> bool:
        return (self.namespace in ("", pod.namespace)) and (
            self.pod in ("", pod.pod_name)
        )
