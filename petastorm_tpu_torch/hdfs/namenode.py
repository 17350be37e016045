"""HDFS namenode resolution from Hadoop configs + HA failover wrapper.

The port's copy of ``petastorm_tpu/hdfs/namenode.py`` (the whole module):
``HdfsNamenodeResolver`` parses ``core-site.xml`` and ``hdfs-site.xml``
found through ``HADOOP_HOME`` / ``HADOOP_PREFIX`` / ``HADOOP_INSTALL``;
``HAHdfsClient`` wraps a connected filesystem and moves to the next
namenode when a call fails with a connection error (a request-shaped
error such as ``FileNotFoundError`` is raised at once, never failed over);
``HdfsConnector.connect_to_either_namenode`` connects to whichever of the
first two namenodes answers.

The client is fsspec's hadoop filesystem (pyarrow's libhdfs under it),
imported only when a namenode is connected.
"""

from __future__ import annotations

import functools
import logging
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

MAX_FAILOVER_ATTEMPTS = 2


class HdfsConnectError(IOError):
    pass


class MaxFailoversExceeded(RuntimeError):
    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = failed_exceptions
        self.max_failover_attempts = max_failover_attempts
        self.__name__ = func_name
        super(MaxFailoversExceeded, self).__init__(
            'Failover attempts exceeded maximum ({}) for function {}; '
            'exceptions: {}'.format(max_failover_attempts, func_name,
                                    failed_exceptions))


class HdfsNamenodeResolver(object):
    """Resolves HDFS name services to lists of namenode host:port pairs from
    Hadoop XML configuration."""

    def __init__(self, hadoop_configuration: Optional[Dict] = None):
        self._hadoop_env = None
        self._hadoop_path = None
        if hadoop_configuration is None:
            hadoop_configuration = self._load_site_configs()
        self._config = hadoop_configuration or {}

    def _load_site_configs(self) -> Dict[str, str]:
        """Locate and parse core-site.xml + hdfs-site.xml (reference :45-83)."""
        config: Dict[str, str] = {}
        for env in ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL'):
            path = os.environ.get(env)
            if not path:
                continue
            conf_dir = os.path.join(path, 'etc', 'hadoop')
            if not os.path.isdir(conf_dir):
                continue
            self._hadoop_env, self._hadoop_path = env, path
            for fname in ('core-site.xml', 'hdfs-site.xml'):
                fpath = os.path.join(conf_dir, fname)
                if os.path.exists(fpath):
                    config.update(self._parse_xml(fpath))
            break
        return config

    @staticmethod
    def _parse_xml(path: str) -> Dict[str, str]:
        out = {}
        try:
            root = ET.parse(path).getroot()
        except ET.ParseError as e:
            logger.warning('Could not parse %s: %s', path, e)
            return out
        for prop in root.iter('property'):
            name = prop.findtext('name')
            value = prop.findtext('value')
            if name is not None and value is not None:
                out[name] = value
        return out

    def resolve_hdfs_name_service(self, namespace: str) -> Optional[List[str]]:
        """Name service → list of namenode 'host:port' (reference :84-118);
        None when the namespace is not a configured name service."""
        namenodes = self._config.get('dfs.ha.namenodes.' + namespace)
        if not namenodes:
            return None
        hosts = []
        for nn in namenodes.split(','):
            address = self._config.get(
                'dfs.namenode.rpc-address.{}.{}'.format(namespace, nn.strip()))
            if address:
                hosts.append(address)
        if not hosts:
            raise HdfsConnectError(
                'Name service {} has namenode ids {} but no rpc-addresses '
                'configured'.format(namespace, namenodes))
        return hosts

    def resolve_default_hdfs_service(self) -> List:
        """[nameservice, [namenodes]] from fs.defaultFS (reference :119-128)."""
        default_fs = self._config.get('fs.defaultFS', '')
        if not default_fs.startswith('hdfs://'):
            raise HdfsConnectError(
                'Unable to determine namenode: fs.defaultFS={!r}'.format(default_fs))
        nameservice = default_fs[len('hdfs://'):].split('/')[0]
        namenodes = self.resolve_hdfs_name_service(nameservice)
        if namenodes is None:
            namenodes = [nameservice]   # direct host(:port), not a nameservice
        return [nameservice, namenodes]


# OSError subclasses that describe the *request*, not the connection: a
# missing file must surface as FileNotFoundError, not trigger namenode
# reconnects and MaxFailoversExceeded (the reference only fails over on
# connection-type ArrowIOError, namenode.py:181).
_NON_FAILOVER_ERRORS = (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError, FileExistsError)


#: Failover backoff/budget (shared RetryPolicy shape; see
#: the port's ``resilience``). Jittered backoff between reconnect attempts
#: keeps a fleet of readers from hammering a recovering namenode in
#: lockstep; the wall budget bounds how long one call can chase failovers.
FAILOVER_BACKOFF_S = 0.1
FAILOVER_TOTAL_BUDGET_S = 60.0


def _failover_classify(exc: BaseException) -> str:
    """Failover classification: request-shaped errors surface immediately;
    connection-shaped ``OSError``/``IOError`` rotate namenodes."""
    from petastorm_tpu_torch import resilience
    if isinstance(exc, _NON_FAILOVER_ERRORS):
        return resilience.PERMANENT
    if isinstance(exc, (IOError, OSError)):
        return resilience.TRANSIENT
    return resilience.PERMANENT


def namenode_failover(func):
    """Retry a filesystem method across namenodes on connection errors
    (reference ``namenode_failover`` decorator, :146-186), driven by the
    shared :class:`petastorm_tpu_torch.resilience.RetryPolicy` — which adds the
    full-jitter backoff between reconnects and the total-wall cap the old
    fixed loop lacked (many readers failing over together must decorrelate,
    not storm the surviving namenode)."""
    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        from petastorm_tpu_torch.resilience import RetryPolicy
        failures = []

        def rotate(exc, _attempt):
            failures.append(exc)
            self._try_next_namenode()

        policy = RetryPolicy(attempts=MAX_FAILOVER_ATTEMPTS + 1,
                             initial_backoff_s=FAILOVER_BACKOFF_S,
                             total_budget_s=FAILOVER_TOTAL_BUDGET_S,
                             classify=_failover_classify)
        try:
            return policy.call(func, self, *args, on_retry=rotate,
                               description=getattr(func, '__name__',
                                                   str(func)), **kwargs)
        except _NON_FAILOVER_ERRORS:
            raise
        except (IOError, OSError) as e:
            failures.append(e)
            raise MaxFailoversExceeded(failures, MAX_FAILOVER_ATTEMPTS,
                                       getattr(func, '__name__', str(func)))
    return wrapper


class HAHdfsClient(object):
    """Wraps a connected hadoop filesystem, reconnecting to the next namenode
    in round-robin order whenever a call raises a connection error
    (reference ``HAHdfsClient`` + ``failover_all_class_methods``, :189-319)."""

    _PROXY_METHODS = ('open', 'ls', 'find', 'info', 'exists', 'makedirs',
                      'rm', 'mv', 'cp_file', 'created', 'modified', 'isdir',
                      'isfile', 'du', 'glob')

    def __init__(self, connector_cls, namenodes: List[str]):
        self._connector_cls = connector_cls
        self._namenodes = list(namenodes)
        # Connect to whichever namenode answers first ('either namenode',
        # reference :275-290) — the first listed may be the standby/down one.
        errors = []
        for i, host_port in enumerate(self._namenodes):
            try:
                self._fs = self._connect(host_port)
                self._index = i
                break
            except (IOError, OSError) as e:
                errors.append(e)
        else:
            raise HdfsConnectError(
                'Could not connect to any namenode of {}: {}'.format(
                    self._namenodes, errors))

    def _connect(self, host_port: str):
        return self._connector_cls(host_port)

    def _try_next_namenode(self):
        """Rotate to the next reachable namenode; when none answers, keep the
        current handle so the retry loop (not a raw connect error) decides when
        to give up."""
        for _ in range(len(self._namenodes)):
            self._index = (self._index + 1) % len(self._namenodes)
            candidate = self._namenodes[self._index]
            logger.warning('Failing over to namenode %s', candidate)
            try:
                self._fs = self._connect(candidate)
                return
            except (IOError, OSError) as e:
                logger.warning('Namenode %s unreachable: %s', candidate, e)

    def __getattr__(self, name):
        if name in self._PROXY_METHODS:
            method = getattr(type(self._fs), name, None)
            if method is None:
                # fall through to plain delegation for fs-specific helpers
                return getattr(self._fs, name)

            @namenode_failover
            def call(self, *args, **kwargs):
                return getattr(self._fs, name)(*args, **kwargs)
            return call.__get__(self, type(self))
        return getattr(self._fs, name)


class HdfsConnector(object):
    """Connect to (HA) HDFS via fsspec/pyarrow (reference :241-319)."""

    MAX_NAMENODES = 2

    @classmethod
    def hdfs_connect_namenode(cls, host_port: str):
        import fsspec
        host, _, port = host_port.partition(':')
        # skip_instance_cache: a failover reconnect must get a FRESH client,
        # not fsspec's cached (possibly wedged) instance for the same args.
        return fsspec.filesystem('hdfs', host=host or 'default',
                                 port=int(port) if port else 8020,
                                 skip_instance_cache=True)

    @classmethod
    def connect_to_either_namenode(cls, namenodes: List[str]):
        """Return an :class:`HAHdfsClient` over up to MAX_NAMENODES namenodes."""
        return HAHdfsClient(cls.hdfs_connect_namenode,
                            namenodes[:cls.MAX_NAMENODES])
