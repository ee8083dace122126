"""Per-bucket notification configuration: the S3
`NotificationConfiguration` XML surface (PUT/GET ``?notification``),
parsed into prefix/suffix/event-type rules that gate which namespace
events reach which targets (pkg/event/rules.go + config.go semantics,
namespace-tolerant parsing like the legacy features/events.py)."""

from __future__ import annotations

import dataclasses
import fnmatch
import xml.etree.ElementTree as ET

# every event name the plane can classify from object state; rule
# patterns must match at least one of these (reference: unknown event
# names are rejected at PutBucketNotification time)
EVENT_NAMES = (
    "s3:ObjectCreated:Put",
    "s3:ObjectCreated:CompleteMultipartUpload",
    "s3:ObjectRemoved:Delete",
    "s3:ObjectRemoved:DeleteMarkerCreated",
    "s3:ObjectRestore:Completed",
    "s3:ObjectTransition:Complete",
)


class NotifyRuleError(ValueError):
    """Malformed notification configuration (bad XML, empty rule,
    unsupported event pattern)."""


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _findall(el, name: str) -> list:
    return [c for c in el if _strip(c.tag) == name]


def _text(el, name: str, default: str = "") -> str:
    for c in _findall(el, name):
        return (c.text or "").strip()
    return default


@dataclasses.dataclass
class NotifyRule:
    """One Queue/Topic/CloudFunction configuration entry."""
    arn: str
    events: list[str]                  # e.g. ["s3:ObjectCreated:*"]
    prefix: str = ""
    suffix: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        if not any(fnmatch.fnmatchcase(event_name, pat)
                   for pat in self.events):
            return False
        if self.prefix and not key.startswith(self.prefix):
            return False
        if self.suffix and not key.endswith(self.suffix):
            return False
        return True

    def unknown_events(self) -> list[str]:
        """Event patterns that can never fire (match no known name)."""
        return [pat for pat in self.events
                if not any(fnmatch.fnmatchcase(n, pat)
                           for n in EVENT_NAMES)]


class BucketNotifyConfig:
    """The parsed per-bucket rule set."""

    def __init__(self, rules: list[NotifyRule]):
        self.rules = rules

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "BucketNotifyConfig":
        try:
            root = ET.fromstring(raw)
        except ET.ParseError as e:
            raise NotifyRuleError(f"malformed notification XML: {e}") \
                from None
        rules = []
        for qel in (_findall(root, "QueueConfiguration")
                    + _findall(root, "TopicConfiguration")
                    + _findall(root, "CloudFunctionConfiguration")):
            arn = (_text(qel, "Queue") or _text(qel, "Topic")
                   or _text(qel, "CloudFunction"))
            if not arn:
                raise NotifyRuleError(
                    "a notification configuration entry names no "
                    "target ARN")
            events = [(e.text or "").strip()
                      for e in _findall(qel, "Event")]
            if not any(events):
                raise NotifyRuleError(
                    f"rule for {arn!r} subscribes to no events")
            prefix = suffix = ""
            for fel in _findall(qel, "Filter"):
                for kel in _findall(fel, "S3Key"):
                    for frel in _findall(kel, "FilterRule"):
                        name = _text(frel, "Name").lower()
                        value = _text(frel, "Value")
                        if name == "prefix":
                            prefix = value
                        elif name == "suffix":
                            suffix = value
            rules.append(NotifyRule(arn=arn, events=events,
                                    prefix=prefix, suffix=suffix))
        return cls(rules)

    def arns(self) -> set[str]:
        return {r.arn for r in self.rules}

    def match(self, event_name: str, key: str) -> set[str]:
        """The target ARNs this (event, key) fans out to."""
        return {r.arn for r in self.rules
                if r.matches(event_name, key)}

    def unknown_events(self) -> list[str]:
        out: list[str] = []
        for r in self.rules:
            out.extend(r.unknown_events())
        return out
