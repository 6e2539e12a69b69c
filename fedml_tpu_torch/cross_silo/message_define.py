"""Message-type constants for the cross-silo FSM (reference
``simulation/mpi/fedavg/message_define.py:7-13`` and
``cross_silo/server/message_define.py``)."""


class MyMessage:
    # server → client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_S2C_FINISH = 7

    # client → server
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
    MSG_TYPE_C2S_SEND_STATS_TO_SERVER = 4
    MSG_TYPE_C2S_CLIENT_STATUS = 5

    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_CLIENT_STATUS = "client_status"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"

    MSG_CLIENT_STATUS_ONLINE = "ONLINE"
    MSG_CLIENT_STATUS_IDLE = "IDLE"
