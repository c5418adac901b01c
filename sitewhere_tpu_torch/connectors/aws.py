"""AWS SQS outbound connector with stdlib SigV4 request signing (port of
``sitewhere_tpu/connectors/aws.py``).

Each persisted event goes as JSON to an SQS queue with access/secret key
credentials (us-east-1 by default). SQS is a plain HTTPS API: requests are
signed with AWS Signature Version 4 (hashlib/hmac) and POSTed with
``aiohttp``, imported when the connector first sends. The signer is
generic SigV4, checked against AWS's published example vectors.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import urllib.parse
from dataclasses import dataclass

from sitewhere_tpu_torch.connectors.base import SerialOutboundConnector
from sitewhere_tpu_torch.outbound.feed import OutboundEvent


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


@dataclass(frozen=True)
class AwsCredentials:
    access_key: str
    secret_key: str
    region: str = "us-east-1"


def sigv4_headers(creds: AwsCredentials, service: str, method: str, url: str,
                  body: bytes, headers: dict[str, str] | None = None,
                  amz_date: str | None = None) -> dict[str, str]:
    """Build the signed header set for one request (AWS Signature Version 4:
    canonical request -> string to sign -> derived signing key -> signature).

    ``amz_date`` (YYYYMMDD'T'HHMMSS'Z') is injectable for deterministic
    tests; defaults to current UTC.
    """
    parsed = urllib.parse.urlsplit(url)
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
    date = amz_date[:8]

    all_headers = {"host": parsed.netloc, "x-amz-date": amz_date,
                   **{k.lower(): v for k, v in (headers or {}).items()}}
    signed_names = ";".join(sorted(all_headers))
    canonical_headers = "".join(
        f"{k}:{' '.join(all_headers[k].split())}\n" for k in sorted(all_headers))

    # canonical query: percent-decode each component WITHOUT '+'-as-space
    # (a literal '+' must survive), re-encode with the SigV4 safe set, and
    # sort the ENCODED pairs — the spec sorts after encoding.
    enc = lambda s: urllib.parse.quote(s, safe="-_.~")  # noqa: E731
    encoded_pairs = []
    if parsed.query:
        for part in parsed.query.split("&"):
            k, _, v = part.partition("=")
            encoded_pairs.append(
                (enc(urllib.parse.unquote(k)), enc(urllib.parse.unquote(v))))
    canonical_query = "&".join(f"{k}={v}" for k, v in sorted(encoded_pairs))

    canonical_request = "\n".join([
        method.upper(),
        urllib.parse.quote(parsed.path or "/", safe="/-_.~"),
        canonical_query,
        canonical_headers,
        signed_names,
        _sha256(body),
    ])

    scope = f"{date}/{creds.region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256(canonical_request.encode()),
    ])

    key = _hmac(("AWS4" + creds.secret_key).encode(), date)
    key = _hmac(key, creds.region)
    key = _hmac(key, service)
    key = _hmac(key, "aws4_request")
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()

    return {
        **{k: v for k, v in (headers or {}).items()},
        "x-amz-date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
            f"SignedHeaders={signed_names}, Signature={signature}"),
    }


class SqsConnector(SerialOutboundConnector):
    """POST each event as a SigV4-signed SQS SendMessage (reference:
    connectors/aws/sqs/SqsOutboundConnector.java). ``queue_url`` may point at
    any SQS-compatible endpoint (tests use a local one)."""

    def __init__(self, connector_id: str, access_key: str, secret_key: str,
                 queue_url: str, region: str = "us-east-1", filters=None):
        if not access_key:
            raise ValueError("Amazon access key not provided.")
        if not secret_key:
            raise ValueError("Amazon secret key not provided.")
        if not queue_url:
            raise ValueError("Amazon SQS queue URL not provided.")
        super().__init__(connector_id, filters)
        self.creds = AwsCredentials(access_key, secret_key, region)
        self.queue_url = queue_url
        self._session = None

    async def _get_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def process_event(self, event: OutboundEvent) -> None:
        body = urllib.parse.urlencode({
            "Action": "SendMessage",
            "Version": "2012-11-05",
            "MessageBody": json.dumps(event.to_json_dict()),
        }).encode()
        headers = sigv4_headers(
            self.creds, "sqs", "POST", self.queue_url, body,
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        session = await self._get_session()
        async with session.post(self.queue_url, data=body,
                                headers=headers) as resp:
            if resp.status >= 300:
                raise RuntimeError(f"sqs send failed: {resp.status}")

    async def on_stop(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
