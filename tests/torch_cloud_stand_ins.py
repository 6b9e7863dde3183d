"""In-memory stand-ins for the S3 and GCS client libraries (boto3,
botocore.config, google.cloud.storage), shaped as ``tests/test_storage.py``
shapes them: LastModified / ``updated`` stamps, ClientError-shaped and
``code``-carrying not-founds, and a record of every call. ``install_boto3``
and ``install_gcs`` put fresh modules into ``sys.modules`` through
``monkeypatch``, so the stores of both packages import them lazily."""

import datetime
import sys
import types

NOW = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)

S3_CONF = {
    "storage_system": "s3",
    "aws_s3": {"access_id": "id", "secret_key": "secret", "region": "eu-west-1",
               "bucket_name": "imgs"},
}
GCS_CONF = {"storage_system": "gcs", "gcs": {"bucket_name": "imgs"}}


class S3NotFound(Exception):
    """botocore ClientError's shape for a missing key."""

    response = {"Error": {"Code": "NoSuchKey"}}


class S3Client:
    """boto3's S3 client: head, get, put and delete over a dict."""

    def __init__(self):
        self.blobs = {}
        self.calls = []

    def head_object(self, Bucket, Key):  # noqa: N803 (boto3's names)
        self.calls.append("head")
        if Key not in self.blobs:
            raise S3NotFound("404")
        return {"LastModified": NOW}

    def get_object(self, Bucket, Key):  # noqa: N803
        self.calls.append("get")
        if Key not in self.blobs:
            raise S3NotFound("NoSuchKey")
        data = self.blobs[Key]
        return {"Body": types.SimpleNamespace(read=lambda: data), "LastModified": NOW}

    def put_object(self, Bucket, Key, Body):  # noqa: N803
        self.calls.append("put")
        self.blobs[Key] = Body

    def delete_object(self, Bucket, Key):  # noqa: N803
        self.calls.append("delete")
        self.blobs.pop(Key, None)


class RecordingConfig:
    """botocore.config.Config, keeping its keyword arguments."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs


def install_boto3(monkeypatch, client_factory=S3Client):
    """Fresh boto3 and botocore.config modules; returns the list of the
    keyword arguments of every ``boto3.client`` call and the clients made."""
    made, kwargs_seen = [], []
    boto3 = types.ModuleType("boto3")

    def client(*_args, **kwargs):
        kwargs_seen.append(kwargs)
        made.append(client_factory())
        return made[-1]

    boto3.client = client
    botocore = types.ModuleType("botocore")
    config = types.ModuleType("botocore.config")
    config.Config = RecordingConfig
    botocore.config = config
    monkeypatch.setitem(sys.modules, "boto3", boto3)
    monkeypatch.setitem(sys.modules, "botocore", botocore)
    monkeypatch.setitem(sys.modules, "botocore.config", config)
    return kwargs_seen, made


class GcsNotFound(Exception):
    code = 404


class GcsBlob:
    def __init__(self, bucket, name):
        self._bucket = bucket
        self._name = name
        self.updated = None

    def _call(self, op, kwargs):
        self._bucket.calls.append((op, dict(kwargs)))

    def exists(self, **kwargs):
        self._call("exists", kwargs)
        return self._name in self._bucket.store

    def upload_from_string(self, data, **kwargs):
        self._call("upload", kwargs)
        if isinstance(data, str):
            data = data.encode()
        self._bucket.store[self._name] = data
        self.updated = NOW

    def download_as_bytes(self, **kwargs):
        self._call("download", kwargs)
        if self._name not in self._bucket.store:
            raise GcsNotFound("404")
        return self._bucket.store[self._name]

    def delete(self, **kwargs):
        self._call("delete", kwargs)
        if self._name not in self._bucket.store:
            raise GcsNotFound("404")
        del self._bucket.store[self._name]


class GcsBucket:
    def __init__(self):
        self.store = {}
        self.calls = []

    def blob(self, name):
        return GcsBlob(self, name)

    def get_blob(self, name, **kwargs):
        self.calls.append(("get_blob", dict(kwargs)))
        if name not in self.store:
            return None
        blob = GcsBlob(self, name)
        blob.updated = NOW
        return blob


def install_gcs(monkeypatch):
    """Fresh google.cloud.storage modules; returns the buckets made (one a
    ``Client``)."""
    buckets = []

    def client(project=None):
        buckets.append(GcsBucket())
        bucket = buckets[-1]
        return types.SimpleNamespace(bucket=lambda name: bucket)

    storage = types.ModuleType("google.cloud.storage")
    storage.Client = client
    cloud = types.ModuleType("google.cloud")
    cloud.storage = storage
    google = types.ModuleType("google")
    google.cloud = cloud
    monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setitem(sys.modules, "google.cloud", cloud)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", storage)
    return buckets
