"""BaseCommunicationManager + Observer ABCs (reference
``core/distributed/communication/base_com_manager.py:7`` and
``observer.py:4``)."""

from __future__ import annotations

import abc

from .message import Message


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type, msg_params) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    @abc.abstractmethod
    def send_message(self, msg: Message):
        ...

    @abc.abstractmethod
    def add_observer(self, observer: Observer):
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: Observer):
        ...

    @abc.abstractmethod
    def handle_receive_message(self):
        """Blocking receive loop; dispatches inbound messages to observers
        until stopped."""
        ...

    @abc.abstractmethod
    def stop_receive_message(self):
        ...
