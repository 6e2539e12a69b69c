"""Single-process federated simulation (port of
``fedml_tpu.simulation.sp.fedavg_api.FedAvgAPI``) for every synchronous
algorithm of the zoo (``core/federated.py``'s registry).

Per round: sample the cohort (host Philox stream, bitwise the JAX
package's), stage its ``(C, S, B)`` index tensor, step mask and weights
with the steps padded to a power of two, gather the cohort's rows of the
per-client state table (SCAFFOLD/FedDyn), run the round function of
:mod:`..round_engine` on the device-resident dataset, scatter the updated
rows back, and keep the round's metrics on the device until a log round
reads them.  Evaluation runs every ``frequency_of_the_test`` rounds and at
the last.

Four options of the JAX engine's round program are ported:

- ``round_block`` K > 1: K rounds a block (:meth:`FedAvgAPI.train_block`),
  staged on a worker thread, copied to the card once, replayed as CUDA
  graphs on the card (a plain loop on the CPU), one host sync a block;
- ``cohort_bucketing``: clients grouped by pow2 step class, one partial
  round a bucket, the aggregates merged exactly;
- ``population`` / ``population_axes``: P experiments over
  :class:`~fedml_tpu_torch.core.federated.HParams` in one round program;
- ``collective_precision`` bf16 / int8: the merge numerator quantized with
  error feedback, the server update on an fp32 master, the clients
  trained from the quantized broadcast copy (``round_engine``).  Its
  rounding noise can be given per round: ``quant_noise(round_idx, shard,
  slot, kind, shape)`` (``shard`` is None here) returns the noise tensor.
  Not with bucketing (refused, as in the JAX package), a population or
  ``round_block`` (not ported; refused by name).

The client-state plane (``store/``):

- ``registered_clients`` N: cohorts sample from N registered ids; per-client
  state is keyed by the id, data and weights come from dataset client
  ``id % num_clients``;
- ``client_store``: SCAFFOLD/FedDyn state in a sparse host store
  (``store_page_size``, ``store_max_pages``, ``store_spill_dir``) in place
  of the dense device table, paged in ahead of the round on the stager's
  worker and written back asynchronously; a fused block runs on a device
  mini-table of the block's rows;
- ``data_paging``: the cohort's examples gathered from a paged host store
  of the training set (``data_page_size``, ``data_max_pages``,
  ``data_spill_dir``), the round fed host-staged batches.

``checkpoint_dir`` saves the server state and the per-client state every
``checkpoint_freq`` rounds (and at the last; a fused block at block
granularity), keeping ``checkpoint_keep``, in ``core/checkpoint.py``'s
format with a sparse sidecar for a client store (``checkpoint_codec=
"wire"``: as wire-fp32 payloads, ``WireCheckpointer``), and ``train()``
resumes from the latest.

The obs plane (``obs/``):

- ``trace`` turns the global tracer on (``trace_path``: the Chrome trace
  written at the end of ``train()``): ``staging``, ``eval``, ``round`` and
  ``block`` spans, one ``obs.round`` record a round (the ObsCarry row the
  round computes on the device when the tracer is on at build time), the
  store's and the stager's spans and counters, graph captures and explicit
  transfer bytes (``obs/torchhooks.py``);
- ``trace_device`` measures the four device phases of one round before
  the loop (``obs/devicetime.py``; ``trace_profile_dir`` adds a
  ``torch.profiler`` Chrome trace of the probe); a failed probe raises,
  and a config the probe cannot split (a population, quantized
  collectives, host-staged data, the mesh engine) is refused by name;
- ``health`` computes the cohort's ``(C,)`` health lanes on the device and
  feeds them to a :class:`~fedml_tpu_torch.obs.health.HealthMonitor`
  (``health_z``, ``health_ewm_alpha``, ``health_min_obs``,
  ``health_slo_path``); not with a population (ValueError, as in the JAX
  package);
- ``metrics_port`` serves ``/metrics``, ``/healthz`` and ``/debug/health``
  on loopback (0: an ephemeral port; ``api.metrics_server``).

The rows and lanes are read on the host in the same copy as the round's
loss, at the sync the round loop makes anyway, and change no result.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ...core import federated
from ...core import rng as rng_util
from ...core import tree as tree_util
from ...core.compression.blockscale import DEFAULT_BLOCK
from ...core.flatmodel import FlatSpec
from ...core.state import resolve_collective_precision
from ...data.federated_dataset import FederatedDataset
from ...device import get_device
from ...ml.aggregator.agg_operator import ServerOptimizer
from ...ml.trainer.local_trainer import LocalTrainer
from ...models.base import TorchModel
from ...obs import get_tracer, torchhooks
from ...obs.carry import obs_host, obs_host_rows, obs_population_rows
from ..round_engine import (BUCKETABLE_ALGS, draw_dropout,
                            make_block_round_fn, make_bucket_agg_fn,
                            make_gather_round_fn, make_population_round_fn,
                            make_round_fn, next_pow2, noise_source)
from ..staging import AsyncCohortStager

log = logging.getLogger(__name__)


def refuse_round_options(args, engine: str):
    """An engine with its own round loop refuses the round-program options
    of :class:`FedAvgAPI` by name, so none is ignored unseen: population
    (``NotImplementedError``), ``cohort_bucketing`` and ``round_block > 1``
    (``ValueError``), as the JAX package's engines do; and the obs plane's
    options, which such an engine does not wire (the JAX package ignores
    them there)."""
    obs = [name for name, on in (
        ("trace", bool(getattr(args, "trace", False))),
        ("trace_device", bool(getattr(args, "trace_device", False))),
        ("health", bool(getattr(args, "health", False))),
        ("metrics_port", getattr(args, "metrics_port", None) is not None))
        if on]
    if obs:
        raise NotImplementedError(
            f"{', '.join(obs)}: not implemented by the port's {engine} (the "
            "sp FedAvgAPI, FedBuffAPI and the mesh's MeshFedAvgAPI run "
            "them)")
    if federated.parse_population(args) is not None:
        raise NotImplementedError(
            f"{engine} does not support population vmap (sp engine only)")
    if bool(getattr(args, "cohort_bucketing", False)):
        raise ValueError(f"{engine} does not implement cohort_bucketing")
    if int(getattr(args, "round_block", 1) or 1) > 1:
        raise ValueError(f"{engine} does not implement round_block fusion")


def fedavg_inside(args, engine: str, names) -> str:
    """The algorithm an engine that runs FedAvg rounds inside (the
    hierarchical and async engines, decentralized SGD) runs: "fedavg",
    when ``federated_optimizer`` names the engine itself or the FedAvg
    family.  Any other algorithm raises, so none runs as FedAvg unseen."""
    alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if alg not in tuple(names) + ("fedavg", "fedavg_seq"):
        raise NotImplementedError(
            f"the {engine} engine runs FedAvg rounds; federated_optimizer "
            f"{alg!r} is not ported to it")
    return "fedavg"


def _host(x) -> np.ndarray:
    """One explicit device→host copy (counted by ``obs/torchhooks.py``)."""
    if isinstance(x, torch.Tensor):
        torchhooks.note_get(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: the nested metrics entries read on the host beside the loss
_READ_WITH_LOSS = ("obs", "health")


def read_metrics(metrics):
    """A round's (or block's) ``train_loss`` and its ``obs``/``health``
    entries on the host in one copy: the device values are concatenated
    (an f32 vector) and copied once, so the obs plane adds no transfer and
    no sync to the loss's own.  Returns ``(loss, {key: {field: array}})``;
    non-tensor fields (FedBuff's host slot maps) pass through."""
    parts = [(None, None, metrics["train_loss"])]
    for key in _READ_WITH_LOSS:
        for f, v in (metrics.get(key) or {}).items():
            parts.append((key, f, v))
    dev = [v for _, _, v in parts if isinstance(v, torch.Tensor)]
    flat = iter(())
    if dev:
        host = _host(torch.cat([v.to(torch.float32).reshape(-1)
                                for v in dev]))
        sizes = np.cumsum([0] + [v.numel() for v in dev])
        flat = iter(host[lo:hi].reshape(tuple(v.shape))
                    for lo, hi, v in zip(sizes[:-1], sizes[1:], dev))
    out, loss = {}, None
    for key, f, v in parts:
        val = next(flat) if isinstance(v, torch.Tensor) else np.asarray(v)
        if key is None:
            loss = val
        else:
            out.setdefault(key, {})[f] = val
    return loss, out


class FedAvgAPI:
    """Runs one algorithm of the zoo on one device.

    ``client_mode``: "scan" (clients one after another), "vmap" (clients
    batched by ``torch.func.vmap``) or "vmap:k" (k clients a batch, as a
    mesh of ``ceil(C / k)`` ranks maps them; ``core/federated.py``).
    ``device`` goes through
    :func:`~fedml_tpu_torch.device.get_device` (None: the card unless
    ``args.device`` is "cpu"), which also sets the card's f32 policy.
    ``algorithm`` (default: ``args.federated_optimizer``) names the
    algorithm; the hierarchical and async engines pass "fedavg".

    ``client_table`` is the per-client state of SCAFFOLD/FedDyn: one row
    per registered client on the device, zero until the client is sampled
    (``None`` for the other algorithms, and with ``client_store``, where
    ``_store`` holds the rows).  With a population every tensor of
    ``state`` and ``client_table`` gains a leading ``(P,)`` member axis."""

    #: whether this class's rounds run the quantized collective layer
    #: (``collective_precision`` bf16/int8); an engine with a round loop
    #: of its own that does not refuses it
    QUANTIZED_ROUNDS = True

    #: whether this class's ``train_one_round`` returns its round
    #: program's own metrics, so the ObsCarry row and the health lanes
    #: reach the records; an engine with a round loop of its own that does
    #: not computes no obs row and refuses ``health`` by name
    OBS_ROUNDS = True

    #: whether the ``trace_device`` probe (``obs/devicetime.py``) can split
    #: this class's round into its four phases; where not it is refused
    DEVICE_PROBE = True

    #: whether this class runs the client-state plane and checkpoints
    #: (``client_store``, ``data_paging``, ``registered_clients``,
    #: ``checkpoint_dir``); an engine that does not refuses them by name
    CLIENT_STATE_PLANE = True

    def _refuse_options(self, args) -> None:
        """The client-state options and ``trace_device`` raise by name on an
        engine or config that does not run them."""
        if bool(getattr(args, "trace_device", False)):
            why = self._probe_refusal(args)
            if why:
                raise NotImplementedError(f"trace_device: {why}")
        plane = [n for n in ("client_store", "data_paging",
                             "registered_clients", "checkpoint_dir")
                 if getattr(args, n, None)]
        if plane and not self.CLIENT_STATE_PLANE:
            raise NotImplementedError(
                f"{', '.join(plane)}: not implemented by the port's "
                f"{type(self).__name__} yet (the sp FedAvgAPI, FedBuffAPI "
                "and the mesh's MeshFedAvgAPI run it)")

    def __init__(self, args, device, dataset: FederatedDataset,
                 model: TorchModel, client_mode: str = "vmap",
                 algorithm=None):
        self._refuse_options(args)
        self.args = args
        self.device = get_device(args, device)
        self.dataset = dataset
        self.model = model
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 10))
        self.epochs = int(getattr(args, "epochs", 1))
        self.comm_rounds = int(getattr(args, "comm_round", 10))
        self.clients_per_round = int(getattr(args, "client_num_per_round", 10))
        self.eval_freq = int(getattr(args, "frequency_of_the_test", 5))
        self._init_obs(args)

        self.trainer = self._make_trainer(model, args, algorithm)
        self.server_opt = ServerOptimizer(args, algorithm)
        # a subclass with its own round loop would silently mis-handle the
        # round-program options: each is refused there by name
        own_loop = type(self).train_one_round is not FedAvgAPI.train_one_round
        self.population = federated.parse_population(args)
        if self.population and own_loop:
            raise NotImplementedError(
                f"{type(self).__name__} does not support population vmap "
                "(sp engine only)")
        self._bucketing = bool(getattr(args, "cohort_bucketing", False))
        if self._bucketing:
            if self.server_opt.algorithm not in BUCKETABLE_ALGS:
                raise ValueError(
                    f"cohort_bucketing supports {BUCKETABLE_ALGS}, not "
                    f"{self.server_opt.algorithm!r}")
            if self.population:
                raise ValueError(
                    "population vmap needs the unbucketed cohort path "
                    "(bucket shapes are data-dependent per member)")
            if own_loop:
                raise ValueError(f"{type(self).__name__} does not implement "
                                 "cohort_bucketing")
        self._bucket_fn = None
        # the collective layer, resolved against the engine's shard count
        # (the mesh engine sets n_shards first, so "auto" sees the mesh)
        self.collective_precision = resolve_collective_precision(
            args, getattr(self, "n_shards", 1))
        self.quant_block = int(getattr(args, "quant_block", 0)
                               or DEFAULT_BLOCK)
        #: per-round rounding noise of the collective layer; None draws it
        #: from the round's generator (``round_engine.noise_source``)
        self.quant_noise = None
        self._round_block = int(getattr(args, "round_block", 1) or 1)
        if self.collective_precision != "fp32":
            if self._bucketing:
                # bucket partials merge on the host: there is no single
                # merge to quantize against one EF buffer
                raise ValueError(
                    "collective_precision requires the unbucketed cohort "
                    "path")
            for name, on in (
                    ("a population", self.population),
                    ("round_block > 1", self._round_block > 1),
                    (type(self).__name__, not self.QUANTIZED_ROUNDS)):
                if on:
                    raise NotImplementedError(
                        f"collective_precision="
                        f"{self.collective_precision!r} with {name} is not "
                        "ported (unset one to run)")
        if self._round_block > 1:
            if self._bucketing:
                raise ValueError(
                    "round_block fusion needs the unbucketed cohort path "
                    "(bucket partials are data-dependent per round)")
            if own_loop and \
                    type(self)._build_block_fn is FedAvgAPI._build_block_fn:
                raise ValueError(f"{type(self).__name__} does not implement "
                                 "round_block fusion")
        self._client_mode = client_mode
        self._block_fn = None
        self._block_stager = None
        self._pinned = {}
        self._h2d_done = None
        # the initial weights are drawn on the CPU, so a seed gives the same
        # model on every device; the rounds draw on the device
        params = model.init(rng_util.purpose_key(rng_util.root_key(self.seed),
                                                 "init"))
        params = {k: v.to(self.device) for k, v in params.items()}
        #: the params' unpadded flat view, in the JAX package's layout
        self.flat = FlatSpec.of(params, 1, model.flat_layout())
        self.state = self._init_server_state(params)
        self._hp = None
        if self.population:
            # every member starts from the same init; the states diverge
            # as the members' hyperparameters differ
            self.state = federated.stack_member_states(self.state,
                                                       self.population.size)
            self._hp = self.population.to(self.device).hparams
        self._root = rng_util.root_key(self.seed, self.device)
        self._test = None
        # the registered id space may exceed the dataset's clients: cohorts
        # sample registered ids, state is keyed by them, data comes from
        # dataset client ``id % num_clients``
        self.registered_clients = (
            int(getattr(args, "registered_clients", 0) or 0)
            or self.dataset.num_clients)
        if self.registered_clients < self.dataset.num_clients:
            raise ValueError(
                f"registered_clients={self.registered_clients} < dataset "
                f"client count {self.dataset.num_clients}")
        self._table_rows = self.registered_clients
        self.round_fn = self._build_round_fn(client_mode)
        torchhooks.note_build("round")
        self.client_table = None
        self._store = None
        self._pager = None
        if self.server_opt.spec.client_state:
            if bool(getattr(args, "client_store", False)):
                if self.population:
                    raise ValueError(
                        "incompatible flags: client_store pages ONE "
                        "experiment's rows; population/population_axes "
                        "needs the dense member-stacked table")
                self._init_client_store()
            else:
                self.client_table = self._init_client_table()
        self._data_store = None
        self._data_pager = None
        if bool(getattr(args, "data_paging", False)):
            self._init_data_pager()
        self.metrics_history = []

    def _probe_refusal(self, args):
        """Why ``trace_device`` cannot run on this engine and config (the
        probe splits one sp round on the device-resident dataset), or
        None."""
        if not self.DEVICE_PROBE:
            return (f"the measured probe is not implemented for the port's "
                    f"{type(self).__name__} (the sp FedAvgAPI and "
                    "FedBuffAPI run it)")
        if federated.parse_population(args) is not None:
            return "a population's rounds are not split by the probe"
        if str(getattr(args, "collective_precision", "fp32")).lower() in (
                "bf16", "int8"):
            return "quantized collective rounds are not split by the probe"
        if not bool(getattr(args, "device_data", True)) or \
                bool(getattr(args, "data_paging", False)):
            return "needs the device-gather cohort path (device_data=True)"
        return None

    def _init_obs(self, args):
        """The obs plane's options (module docstring): ``trace`` turns the
        global tracer on; the round builders compute the ObsCarry row when
        it is on now (``self._obs``), the health lanes under ``health``."""
        if bool(getattr(args, "trace", False)):
            from ...obs import configure
            configure(enabled=True, path=getattr(args, "trace_path", None))
        self._tracer = get_tracer()
        self._obs = self._tracer.enabled and self.OBS_ROUNDS
        self._health = bool(getattr(args, "health", False))
        self.health_monitor = None
        self.metrics_server = None
        if self._health:
            if not self.OBS_ROUNDS:
                raise NotImplementedError(
                    f"health: not implemented by the port's "
                    f"{type(self).__name__} (its rounds return no per-client "
                    "lanes; the sp FedAvgAPI, FedBuffAPI and the mesh's "
                    "MeshFedAvgAPI run it)")
            if federated.parse_population(args) is not None:
                raise ValueError(
                    "incompatible flags: health + population — per-client "
                    "health rows are single-experiment (the stat stream "
                    "is keyed by client id, not member)")
            from ...obs.health import HealthMonitor
            self.health_monitor = HealthMonitor.from_args(args)
        if getattr(args, "metrics_port", None) is not None:
            from ...obs.metricsd import start_from_args
            self.metrics_server = start_from_args(
                args, monitor=self.health_monitor)

    def _obs_opts(self) -> dict:
        """The round builders' obs arguments."""
        return dict(obs=self._obs, health=self._health)

    def _make_trainer(self, model, args, algorithm):
        """The client trainer (the mesh engine's pipeline layout makes its
        own)."""
        return LocalTrainer(model, args, algorithm)

    def _init_server_state(self, params):
        """The initial server state; with quantized collectives it also
        holds the EF row, the fp32 flat master and at int8 the broadcast
        residual.  The mesh engine overrides the layout."""
        return self.server_opt.init(
            params, collective_precision=self.collective_precision,
            flat=self.flat)

    def _init_client_table(self):
        """The per-client state table: one zero row per dataset client
        (member-stacked with a population)."""
        gp = self.state.global_params
        if self.population:
            gp = federated.population_member(gp, 0)
        table = tree_util.client_table_init(gp, self._table_rows)
        if self.population:
            table = federated.stack_member_states(table,
                                                  self.population.size)
        return table

    def reset_params(self, params):
        """Restart from ``params`` (a ``{name: tensor}`` dict): the server
        state is made anew from them, as at construction.  Parity runs
        start both packages from the same weights this way."""
        params = {k: v.to(self.device) for k, v in params.items()}
        state = self._init_server_state(params)
        if self.population:
            state = federated.stack_member_states(state,
                                                  self.population.size)
        self.state = state

    def _quant(self) -> dict:
        """The round builders' quantization arguments."""
        return dict(collective_precision=self.collective_precision,
                    quant_block=self.quant_block, flat=self.flat)

    def _noise(self, round_idx: int, gen, shard=None):
        """The round's ``noise(slot, kind, shape)``: the ``quant_noise``
        hook's tensors when set, else :func:`noise_source` of ``gen``."""
        if self.quant_noise is None:
            return noise_source(gen, shard)
        hook = self.quant_noise

        def noise(slot, kind, shape):
            x = hook(round_idx, shard, slot, kind, shape)
            return x.to(self.device) if isinstance(x, torch.Tensor) \
                else torch.tensor(np.asarray(x), device=self.device)

        return noise

    def _build_round_fn(self, client_mode: str):
        # data_paging forces the host-staged path: a paged training set is
        # never uploaded whole
        if bool(getattr(self.args, "device_data", True)) and \
                not bool(getattr(self.args, "data_paging", False)):
            # the training set lives on the device once; rounds ship only
            # index tensors
            self._dev_x = torch.as_tensor(self.dataset.train_x,
                                          device=self.device)
            self._dev_y = torch.as_tensor(self.dataset.train_y,
                                          device=self.device)
            if self.population:
                # P experiments, one program: the gather round mapped over
                # the member axis of (state, table rows, hparams)
                return make_population_round_fn(
                    self.trainer, self.server_opt, self._dev_x, self._dev_y,
                    self.population, mode=client_mode, obs=self._obs)
            return make_gather_round_fn(self.trainer, self.server_opt,
                                        self._dev_x, self._dev_y,
                                        mode=client_mode, **self._quant(),
                                        **self._obs_opts())
        if self.population:
            raise ValueError(
                "population vmap needs the device-gather cohort path "
                "(device_data=True): members share one staged cohort")
        return make_round_fn(self.trainer, self.server_opt, mode=client_mode,
                             **self._quant(), **self._obs_opts())

    # -- round pieces --------------------------------------------------------
    def _client_sampling(self, round_idx: int) -> np.ndarray:
        return rng_util.sample_clients(self.seed, round_idx,
                                       self.registered_clients,
                                       self.clients_per_round)

    def _data_ids(self, clients) -> np.ndarray:
        """The dataset clients behind a cohort of registered ids: the ids
        themselves, or folded modulo the dataset's client count when the
        registered population is larger."""
        clients = np.asarray(clients)
        if self.registered_clients == self.dataset.num_clients:
            return clients
        return clients % self.dataset.num_clients

    # -- the client-state plane ------------------------------------------------
    def _init_client_store(self):
        """The sparse host store in place of the dense table
        (``store/``): host memory scales with the touched ids (LRU-capped
        with spill), and the round gets the same cohort-stacked rows."""
        from ...store import ClientStateStore, CohortStatePager
        args = self.args
        row_t = {k: np.zeros(tuple(v.shape),
                             torch.empty(0, dtype=v.dtype).numpy().dtype)
                 for k, v in self.state.global_params.items()}
        self._store = ClientStateStore(
            row_t, self.registered_clients,
            page_size=int(getattr(args, "store_page_size", 256) or 256),
            max_resident_pages=int(getattr(args, "store_max_pages", 0) or 0),
            spill_dir=self._spill_dir(getattr(args, "store_spill_dir",
                                              None)))
        self._pager = CohortStatePager(
            self._store, self._cohort_ids_for,
            depth=int(getattr(args, "staging_depth", 1) or 1),
            stride=self._round_block, limit=self.comm_rounds,
            enabled=bool(getattr(args, "async_staging", True)))

    def _spill_dir(self, path):
        """Where this process's store spills (the mesh engine gives each
        rank a directory of its own)."""
        return path

    def _cohort_ids_for(self, round_idx: int) -> np.ndarray:
        """The state ids round (or the fused block starting at)
        ``round_idx`` touches: pure in the round index, so the pager's
        worker may page them in ahead."""
        if self._round_block > 1:
            k = min(self._round_block, self.comm_rounds - round_idx)
            return np.unique(np.concatenate(
                [self._client_sampling(r)
                 for r in range(round_idx, round_idx + k)]))
        return self._client_sampling(round_idx)

    def _init_data_pager(self):
        """The training set as a read-only paged store of single examples
        (``{"x", "y"}`` rows keyed by train index), gathered per round by a
        :class:`~fedml_tpu_torch.store.CohortStatePager` whose worker pages
        the next round's examples in."""
        from ...store import ClientStateStore, CohortStatePager
        args = self.args
        ds = self.dataset
        row_t = {"x": np.zeros(ds.train_x.shape[1:], ds.train_x.dtype),
                 "y": np.zeros(ds.train_y.shape[1:], ds.train_y.dtype)}
        page = int(getattr(args, "data_page_size", 0) or 0) or \
            int(getattr(args, "store_page_size", 256) or 256)
        n = len(ds.train_x)
        self._data_store = ClientStateStore(
            row_t, n, page_size=page,
            max_resident_pages=int(getattr(args, "data_max_pages", 0) or 0),
            spill_dir=self._spill_dir(getattr(args, "data_spill_dir",
                                              None)))
        # filled a page at a time: with a resident cap the LRU spills as it
        # goes, so no second dense copy is ever held
        for lo in range(0, n, page):
            ids = np.arange(lo, min(lo + page, n), dtype=np.int64)
            self._data_store.scatter(
                ids, {"x": ds.train_x[ids], "y": ds.train_y[ids]})
        self._data_pager = CohortStatePager(
            self._data_store, self._example_ids_for,
            depth=int(getattr(args, "staging_depth", 1) or 1),
            limit=self.comm_rounds,
            enabled=bool(getattr(args, "async_staging", True)))

    def _example_ids_for(self, round_idx: int) -> np.ndarray:
        clients = self._client_sampling(round_idx)
        idx, _m, _w = self.dataset.cohort_indices(
            self._data_ids(clients), self.batch_size, self.seed, round_idx,
            self.epochs)
        return np.unique(idx.ravel())

    def _paged_cohort_batches(self, clients, round_idx: int):
        """``dataset.cohort_batches``'s values through the example pager:
        the round's unique rows gathered once, then laid out ``(cohort,
        steps, batch, ...)`` by position (padding steps carry row 0 under a
        zero mask, as the index path does)."""
        ds = self.dataset
        idx, mask, w = ds.cohort_indices(
            self._data_ids(clients), self.batch_size, self.seed, round_idx,
            self.epochs)
        uniq = np.unique(idx.ravel())
        nxt = round_idx + 1
        rows = self._data_pager.gather(
            round_idx, uniq, prefetch=nxt if nxt < self.comm_rounds else None)
        pos = np.searchsorted(uniq, idx.ravel())
        x = rows["x"][pos].reshape(idx.shape + ds.train_x.shape[1:])
        y = rows["y"][pos].reshape(idx.shape + ds.train_y.shape[1:])
        return x, y, mask, w

    def _stage_round_arrays(self, round_idx: int):
        """The round's index tensor, step mask and client weights, with the
        steps padded to a power of two (a bounded set of shapes)."""
        clients = self._client_sampling(round_idx)
        idx, mask, w = self.dataset.cohort_indices(
            self._data_ids(clients), self.batch_size, self.seed, round_idx,
            self.epochs)
        steps = next_pow2(idx.shape[1])
        if steps != idx.shape[1]:
            pad = steps - idx.shape[1]
            idx = np.pad(idx, [(0, 0), (0, pad), (0, 0)])
            mask = np.pad(mask, [(0, 0), (0, pad)])
        return clients, idx, mask, w, steps

    def _to_device(self, *arrays):
        """One explicit host→device copy (counted by
        ``obs/torchhooks.py``)."""
        torchhooks.note_put(arrays)
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _table_axis(self) -> int:
        return 1 if self.population else 0

    def _gather_c(self, cohort, round_idx: int = 0):
        """The cohort's rows of the per-client state, stacked on the
        device: from the dense table, or paged in from the store (the pager
        prefetches the next round's pages); ``None`` for an algorithm
        without per-client state."""
        if self._pager is not None:
            nxt = round_idx + self._round_block
            rows = self._pager.gather(
                round_idx, cohort,
                prefetch=nxt if nxt < self.comm_rounds else None)
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in rows.items()}
        if self.client_table is None:
            return None
        return tree_util.cohort_gather(self.client_table, cohort,
                                       self._table_axis())

    def _scatter_c(self, cohort, new_rows, round_idx: int = 0):
        if new_rows is None:
            return
        if self._pager is not None:
            # asynchronous: the copy to the host and the store scatter run
            # on the pager's writer, the next gather drains it first
            self._pager.write_back(round_idx, cohort, new_rows)
            return
        if self.client_table is None:
            return
        self.client_table = tree_util.cohort_scatter(
            self.client_table, cohort, new_rows, self._table_axis())

    def train_one_round(self, round_idx: int):
        if self._bucketing:
            return self._train_one_round_bucketed(round_idx)
        gen = rng_util.round_key(self._root, round_idx)
        noise = self._noise(round_idx, gen)
        if hasattr(self, "_dev_x"):
            with self._tracer.span("staging", cat="staging",
                                   round=round_idx):
                clients, idx, mask, w, steps = self._stage_round_arrays(
                    round_idx)
                idx, mask, w = self._to_device(idx, mask, w)
            c_stacked = self._gather_c(clients, round_idx)
            self.state, metrics, new_c = self.round_fn(
                self.state, idx, mask, w, gen, c_stacked, self._hp, noise)
        else:
            clients = self._client_sampling(round_idx)
            with self._tracer.span("staging", cat="staging",
                                   round=round_idx):
                if self._data_pager is not None:
                    x, y, mask, w = self._paged_cohort_batches(clients,
                                                               round_idx)
                else:
                    x, y, mask, w = self.dataset.cohort_batches(
                        self._data_ids(clients), self.batch_size, self.seed,
                        round_idx, self.epochs)
                steps = next_pow2(x.shape[1])
                if steps != x.shape[1]:
                    pad = [(0, 0), (0, steps - x.shape[1])]
                    x = np.pad(x, pad + [(0, 0)] * (x.ndim - 2))
                    y = np.pad(y, pad + [(0, 0)] * (y.ndim - 2))
                    mask = np.pad(mask, pad)
                x, y, mask, w = self._to_device(x, y, mask, w)
            c_stacked = self._gather_c(clients, round_idx)
            self.state, metrics, new_c = self.round_fn(
                self.state, x, y, mask, w, gen, c_stacked, None, noise)
        self._scatter_c(clients, new_c, round_idx)
        metrics = dict(metrics)
        metrics["allocated_steps"] = len(clients) * steps
        return metrics

    # -- cohort bucketing ----------------------------------------------------
    def _train_one_round_bucketed(self, round_idx: int):
        """Ragged-cohort round: clients grouped into pow2 step-count
        buckets, one partial program per bucket, aggregates merged exactly
        (``round_engine.make_bucket_agg_fn``), one server step.  Cuts the
        masked steps a single max-steps cohort runs under skewed splits.
        The whole cohort's dropout masks are drawn once, as the unbucketed
        round draws them, and sliced per bucket."""
        dev = hasattr(self, "_dev_x")
        if self._bucket_fn is None:
            self._bucket_fn = make_bucket_agg_fn(
                self.trainer, self.server_opt, mode=self._client_mode,
                train_x=self._dev_x if dev else None,
                train_y=self._dev_y if dev else None)
            torchhooks.note_build("bucket")
        clients = self._data_ids(self._client_sampling(round_idx))
        per = [self.dataset.client_index_batches(
            int(c), self.batch_size, self.seed, round_idx, self.epochs)
            for c in clients]
        weights_all = self.dataset.client_sample_counts()[clients].astype(
            np.float32)
        drop_all = draw_dropout(
            self.model, rng_util.round_key(self._root, round_idx),
            (len(clients), next_pow2(max(p.shape[0] for p in per)),
             self.batch_size))
        buckets = {}
        for pos, p in enumerate(per):
            buckets.setdefault(next_pow2(p.shape[0]), []).append(pos)

        partials, total_ws, loss_ws, step_sums = [], [], [], []
        for steps, positions in sorted(buckets.items()):
            cb = next_pow2(len(positions))
            idx = np.zeros((cb, steps, self.batch_size), np.int32)
            mask = np.zeros((cb, steps), np.float32)
            w = np.zeros((cb,), np.float32)
            for i, pos in enumerate(positions):
                s = per[pos].shape[0]
                idx[i, :s], mask[i, :s] = per[pos], 1.0
                w[i] = weights_all[pos]
            drop = None
            if drop_all is not None:
                rows = torch.as_tensor(positions, device=self.device)
                drop = tuple(torch.cat([
                    d[rows, :steps], torch.zeros(
                        (cb - len(positions), steps) + tuple(d.shape[2:]),
                        dtype=d.dtype, device=d.device)]) for d in drop_all)
            if dev:
                inputs = self._to_device(idx, mask, w)
            else:
                inputs = self._to_device(self.dataset.train_x[idx],
                                         self.dataset.train_y[idx], mask, w)
            agg, tw, lw, ts = self._bucket_fn(self.state, *inputs, drop)
            partials.append(agg)
            total_ws.append(tw)
            loss_ws.append(lw)
            step_sums.append(ts)

        merged = self.server_opt.merge_aggregates(partials, total_ws)
        self.state = self.server_opt.update_from_aggregates(self.state,
                                                            merged)
        allocated = sum(next_pow2(len(p)) * s for s, p in buckets.items())
        return {"train_loss": sum(loss_ws) / sum(total_ws),
                "total_steps": sum(step_sums),
                # client-lane step slots this round allocated (the padding
                # bucketing exists to shrink)
                "allocated_steps": allocated}

    # -- fused round blocks --------------------------------------------------
    def _build_block_fn(self):
        """``round_engine.make_block_round_fn`` over the device-resident
        dataset (the population's block with a population)."""
        if not hasattr(self, "_dev_x"):
            raise ValueError(
                "round_block fusion needs the device-gather cohort path "
                "(device_data=True): staging a block is cheap only when "
                "rounds ship index tensors, not data")
        return make_block_round_fn(self.trainer, self.server_opt,
                                   self._dev_x, self._dev_y,
                                   mode=self._client_mode,
                                   population=self.population,
                                   **self._obs_opts())

    def _stage_block(self, start_round: int):
        """One block's stacked cohort arrays, host numpy only: every
        per-round input gains a leading round axis of length ``k =
        min(round_block, comm_rounds - start_round)`` (the ragged tail
        block is shorter).  Steps pad to the block-max pow2 class; each
        round's own class is kept, and the block runs each round at it.
        The cohort ids are checked here: the block indexes the client
        table with them on the device, where an out-of-range id cannot be
        dropped.  A pure function of ``start_round``, safe for the
        stager's worker thread."""
        k = min(self._round_block, self.comm_rounds - start_round)
        rows = self._table_rows
        per = []
        for r in range(start_round, start_round + k):
            clients = self._client_sampling(r)
            if np.min(clients) < 0 or np.max(clients) >= rows:
                raise ValueError(f"block at round {start_round}: cohort ids "
                                 f"outside the {rows} table rows")
            idx, mask, w = self.dataset.cohort_indices(
                self._data_ids(clients), self.batch_size, self.seed, r,
                self.epochs)
            per.append((clients, idx, mask, w))
        round_steps = [next_pow2(p[1].shape[1]) for p in per]
        steps = max(round_steps)
        n = per[0][1].shape[0]
        idx_blk = np.zeros((k, n, steps, self.batch_size), np.int32)
        mask_blk = np.zeros((k, n, steps), np.float32)
        w_blk = np.zeros((k, n), np.float32)
        cohort_blk = np.zeros((k, n), np.int64)
        for i, (clients, idx, mask, w) in enumerate(per):
            s = idx.shape[1]
            idx_blk[i, :, :s] = idx
            mask_blk[i, :, :s] = mask
            w_blk[i] = w
            cohort_blk[i] = clients
        return k, round_steps, idx_blk, mask_blk, w_blk, cohort_blk

    def _block_to_device(self, *arrays):
        """A staged block's arrays on the device: on the card through
        pinned host buffers kept per shape, copied without blocking the
        host (the previous block's copy has finished before a buffer is
        refilled)."""
        torchhooks.note_put(arrays)
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(a) for a in arrays)
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
        out = []
        for i, a in enumerate(arrays):
            key = (i, a.shape, a.dtype.str)
            buf = self._pinned.get(key)
            if buf is None:
                buf = self._pinned[key] = torch.from_numpy(a).pin_memory()
            else:
                buf.numpy()[...] = a
            out.append(buf.to(self.device, non_blocking=True))
        self._h2d_done = torch.cuda.Event()
        self._h2d_done.record()
        return tuple(out)

    def train_block(self, start_round: int):
        """Run ``min(round_block, comm_rounds - start_round)`` rounds as one
        block.  Returns ``(k, metrics)`` with each metrics leaf a stacked
        ``(k,)`` device tensor (``(P, k)`` with a population): the caller
        syncs the whole block at once."""
        if self._block_fn is None:
            self._block_fn = self._build_block_fn()
            torchhooks.note_build("block")
        if self._block_stager is None:
            self._block_stager = AsyncCohortStager(
                self._stage_block,
                enabled=bool(getattr(self.args, "async_staging", True)),
                depth=int(getattr(self.args, "staging_depth", 1) or 1),
                stride=self._round_block, limit=self.comm_rounds)
        nxt = start_round + self._round_block
        k, round_steps, *staged = self._block_stager.get(
            start_round, prefetch=nxt if nxt < self.comm_rounds else None)
        table = self.client_table
        if self._pager is not None:
            staged[3], table, ids = self._block_mini_table(start_round,
                                                           staged[3])
        idx, mask, w, cohort = self._block_to_device(*staged)
        gens = [rng_util.round_key(self._root, r)
                for r in range(start_round, start_round + k)]
        self.state, metrics, table = self._block_fn(
            self.state, idx, mask, w, gens, cohort, table, self._hp,
            round_steps)
        if self._pager is not None:
            self._pager.write_back(start_round, ids, table)
        else:
            self.client_table = table
        metrics = dict(metrics)
        metrics["allocated_steps"] = idx.shape[1] * np.asarray(round_steps,
                                                               np.int64)
        return k, metrics

    def _block_mini_table(self, start_round: int, cohort_blk):
        """A fused block against the store: the block's touched rows go to
        a device mini-table of ``round_block x cohort`` rows (one size for
        every block, so the captured graphs keep their buffers), the cohort
        ids are remapped to its rows, and the whole mini-table writes back
        after the block.  Returns ``(local cohort, mini-table, ids)``, the
        ids padded with the out-of-range sentinel the write-back drops."""
        real = np.unique(cohort_blk)
        local = np.searchsorted(real, cohort_blk).astype(np.int64)
        n_slots = self._round_block * cohort_blk.shape[1]
        nxt = start_round + self._round_block
        rows = self._pager.gather(
            start_round, real,
            prefetch=nxt if nxt < self.comm_rounds else None)
        mini = {k: torch.as_tensor(np.concatenate(
            [r, np.zeros((n_slots - len(real),) + r.shape[1:], r.dtype)]))
            .to(self.device) for k, r in rows.items()}
        ids = np.full(n_slots, self.registered_clients, np.int64)
        ids[:len(real)] = real
        return local, mini, ids

    # -- checkpoints -----------------------------------------------------------
    def _checkpointer(self):
        """The run's :class:`~fedml_tpu_torch.core.checkpoint
        .RoundCheckpointer` (``checkpoint_dir``, ``checkpoint_keep``), a
        :class:`~fedml_tpu_torch.core.checkpoint.WireCheckpointer` under
        ``checkpoint_codec="wire"``, or None."""
        ckpt_dir = getattr(self.args, "checkpoint_dir", None)
        if not ckpt_dir:
            return None
        if not hasattr(self, "_ckpt"):
            from ...core import checkpoint
            keep = int(getattr(self.args, "checkpoint_keep", 3))
            codec = str(getattr(self.args, "checkpoint_codec", "") or "")
            if codec.lower() == "wire":
                from ...core.wire import ParamLayout
                self._ckpt = checkpoint.WireCheckpointer(
                    ckpt_dir, keep, ParamLayout.of(self.model))
            else:
                self._ckpt = checkpoint.RoundCheckpointer(ckpt_dir, keep)
        return self._ckpt

    def _client_state(self):
        return self._store if self._store is not None else self.client_table

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint if there is one; returns the round
        to start from."""
        from ...core.checkpoint import state_from_flat, state_to_flat
        ckpt = self._checkpointer()
        if ckpt is None or ckpt.latest_round() is None:
            return 0
        flat, client = ckpt.restore(
            template=(state_to_flat(self.state), self._client_state()))
        self.state = state_from_flat(flat, self.state)
        if self.client_table is not None:
            self.client_table = client
        return int(ckpt.latest_round()) + 1

    def _checkpoint_due(self, round_idx: int, window: int) -> bool:
        freq = int(getattr(self.args, "checkpoint_freq", 10))
        return (round_idx == self.comm_rounds - 1
                or any((round_idx - j) % freq == 0 for j in range(window)))

    def maybe_checkpoint(self, round_idx: int, window: int = 1):
        """Save when any round of ``[round_idx - window + 1, round_idx]``
        hits ``checkpoint_freq`` or ``round_idx`` is the last (a fused block
        saves at block granularity: its state exists only at block ends)."""
        from ...core.checkpoint import state_to_flat
        ckpt = self._checkpointer()
        if ckpt is None:
            return
        if self._checkpoint_due(round_idx, window):
            if self._pager is not None:
                # every completed round's rows are in the store first
                self._pager.drain_writebacks()
            ckpt.save(round_idx, state_to_flat(self.state),
                      self._client_state())

    # -- evaluation and records ----------------------------------------------
    def evaluate(self):
        with self._tracer.span("eval", cat="eval"):
            return self._evaluate()

    def _evaluate(self):
        if self._test is None:
            self._test = self._to_device(*self.dataset.test_batches())
        if self.population:
            # every member scored on the shared test set; the scalar return
            # is the members' mean, the per-member arrays land on
            # ``member_eval``
            res = np.asarray([self.trainer.evaluate(
                federated.population_member(self.state.global_params, m),
                *self._test) for m in range(self.population.size)],
                np.float32)
            self.member_eval = {"loss": res[:, 0], "acc": res[:, 1]}
            return float(res[:, 0].mean()), float(res[:, 1].mean())
        return self.trainer.evaluate(self.state.global_params, *self._test)

    @torch.no_grad()
    def evaluate_per_client(self, split: str = "train", batch_size: int = 64):
        """The global model scored on every client's local data (the
        reference's ``_local_test_on_all_clients``): per-client accuracy
        and loss, and the accuracy's mean, std, min and 10th percentile.
        ``split="test"`` takes the natural per-client test partition where
        the dataset has one, else the train split."""
        if self.population:
            raise NotImplementedError(
                "evaluate_per_client of a population: score one member")
        clients, X, Y, M = self.dataset.pack_per_client(batch_size, split)
        params = self.state.global_params
        eval_step = self.trainer.make_eval_step()
        losses, accs = [], []
        for xb, yb, mb in zip(X, Y, M):
            tot = torch.zeros(3, dtype=torch.float32, device=self.device)
            for b in zip(*self._to_device(xb, yb, mb)):
                tot = tot + torch.stack(eval_step(params, *b))
            n = torch.clamp_min(tot[2], 1.0)
            losses.append(tot[0] / n)
            accs.append(tot[1] / n)
        accs = torch.stack(accs).cpu().numpy()
        return {
            "per_client_acc": accs,
            "per_client_loss": torch.stack(losses).cpu().numpy(),
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "acc_min": float(accs.min()),
            "acc_p10": float(np.percentile(accs, 10)),
        }

    def _is_log_round(self, round_idx: int) -> bool:
        return (round_idx % self.eval_freq == 0
                or round_idx == self.comm_rounds - 1)

    def _record(self, round_idx, losses, dt):
        """One round's record: ``losses`` is the round's loss, or the
        members' ``(P,)`` losses."""
        losses = np.asarray(losses)
        record = {"round": round_idx, "train_loss": float(losses.mean()),
                  "round_time": dt,
                  "dataset_provenance": getattr(self.dataset, "provenance",
                                                "unknown")}
        if self.population:
            record.update(members=self.population.size,
                          member_train_loss_best=float(losses.min()),
                          member_train_loss_worst=float(losses.max()))
        return record

    def _attach_eval(self, record, note=""):
        test_loss, test_acc = self.evaluate()
        record.update(test_loss=test_loss, test_acc=test_acc)
        log.info("round %d: train_loss=%.4f test_acc=%.4f (%s%.2fs)",
                 record["round"], record["train_loss"], test_acc, note,
                 record["round_time"])

    def _observe_health(self, round_idx: int, metrics: dict, lanes: dict,
                        dt: float):
        """Feed one round's host health lanes to the monitor.
        ``health_clients`` (FedBuff's slot→client map) wins over the round
        sampling; the lanes may be cohort-padded: the monitor trims to the
        id list and drops weight-0 rows."""
        ids = metrics.get("health_clients")
        if ids is None:
            ids = self._client_sampling(round_idx)
        self.health_monitor.observe_round(round_idx, np.asarray(ids), lanes,
                                          round_time_s=dt)

    def _flush_round_records(self, pending):
        """Turn deferred per-round metrics into host records.  Reading the
        losses here is the one device→host sync for every round since the
        last flush; the round's obs row and health lanes come in the same
        copy (:func:`read_metrics`)."""
        while pending:
            round_idx, metrics, dt = pending.pop(0)
            losses, extra = read_metrics(metrics)
            if self._tracer.enabled and "obs" in extra:
                self._tracer.round_obs(round_idx, dt, obs_population_rows(
                    extra["obs"], losses)[0] if self.population
                    else obs_host(extra["obs"]))
            if self.health_monitor is not None and "health" in extra:
                self._observe_health(round_idx, metrics, extra["health"],
                                     dt)
            record = self._record(round_idx, losses, dt)
            if self._is_log_round(round_idx):
                self._attach_eval(record)
            self.metrics_history.append(record)

    def _train_fused(self, start_round: int = 0):
        """The fused round loop: ``round_block`` rounds a block, one host sync a
        block (the stacked losses, with the obs rows and health lanes), the
        next block staged on the worker thread while this one runs; one
        record a round, the evaluation on the last round of a block that
        holds a log round."""
        r = start_round
        while r < self.comm_rounds:
            t0 = time.time()
            with self._tracer.span("block", cat="round", start_round=r):
                k, ms = self.train_block(r)
                losses, extra = read_metrics(ms)   # the block's one sync
            block_dt = time.time() - t0
            if self._tracer.enabled and "obs" in extra:
                rows = (obs_population_rows(extra["obs"], losses)
                        if self.population else obs_host_rows(extra["obs"]))
                for j, row in enumerate(rows):
                    self._tracer.round_obs(r + j, block_dt / k, row)
            if self.health_monitor is not None and "health" in extra:
                # the (K, C) lanes: one observe a round, ids re-derived
                # from the sampling
                for j in range(k):
                    self.health_monitor.observe_round(
                        r + j, self._client_sampling(r + j),
                        {f: v[j] for f, v in extra["health"].items()},
                        round_time_s=block_dt / k)
            eval_due = any(self._is_log_round(ri) for ri in range(r, r + k))
            for j in range(k):
                record = self._record(r + j, losses[..., j], block_dt / k)
                if j == k - 1 and eval_due:
                    self._attach_eval(record, f"block of {k}, ")
                self.metrics_history.append(record)
            self.maybe_checkpoint(r + k - 1, window=k)
            r += k
        if self._block_stager is not None:
            self._block_stager.close()
            self._block_stager = None

    def train(self):
        t_start = time.time()
        start_round = self.maybe_resume()
        if self._tracer.enabled and \
                bool(getattr(self.args, "trace_device", False)):
            # one out-of-band probe of the four device phases before the
            # loop: its own launches and syncs never touch the rounds; a
            # failure raises (no silent fallback to the FLOP model)
            from ...obs.devicetime import measure_device_phases
            measure_device_phases(
                self, round_idx=start_round,
                profile_dir=getattr(self.args, "trace_profile_dir", None))
        if self._round_block > 1:
            self._train_fused(start_round)
        else:
            pending = []
            for round_idx in range(start_round, self.comm_rounds):
                t0 = time.time()
                with self._tracer.span("round", cat="round",
                                       round=round_idx):
                    metrics = self.train_one_round(round_idx)
                pending.append((round_idx, metrics, time.time() - t0))
                if self._is_log_round(round_idx):
                    self._flush_round_records(pending)
                self.maybe_checkpoint(round_idx)
            self._flush_round_records(pending)
        if self._pager is not None:
            # the store holds the final round's rows before anyone reads it
            self._pager.drain_writebacks()
            log.info("fedstore: %s", self._pager.stats())
        if self._data_pager is not None:
            log.info("fedstore data plane: %s", self._data_pager.stats())
        total = time.time() - t_start
        log.info("finished %d rounds in %.1fs (%.3fs/round)",
                 self.comm_rounds, total, total / max(self.comm_rounds, 1))
        if self._tracer.enabled and self._tracer.path:
            # trace_path: the Chrome trace on disk without the tracer API
            self._tracer.export_chrome()
            log.info("fedtrace: wrote %s (analyze with tools/fedtrace.py)",
                     self._tracer.path)
        return self.state.global_params
